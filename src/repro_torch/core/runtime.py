"""CacheRuntime — the one object that holds all semantic-cache state, plus
the typed plugin seams (PyTorch port of ``repro.core.runtime``).

``CacheRuntime`` bundles the slab, the counters, the policy state and the
index state, so a serve step is a function ``runtime -> runtime`` and a
checkpoint is ``save(runtime)``. Index and policy implementations are
interchangeable behind the ``Index`` / ``Policy`` protocols; a stateless
index (``ExactIndex``) carries an empty state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol, runtime_checkable

import torch

from repro_torch.core.types import CacheConfig, CacheState, CacheStats


@runtime_checkable
class Index(Protocol):
    """ANN index plugin seam. An index is a frozen strategy object; its
    mutable state lives in the runtime's ``index_state``."""

    def init(self, config: CacheConfig) -> Any:
        """Fresh index state with static shapes derived from ``config``."""
        ...

    def search(self, istate: Any, queries: torch.Tensor, keys: torch.Tensor,
               alive: torch.Tensor, *,
               interval: tuple[torch.Tensor, torch.Tensor] | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(B,d) queries vs the slab -> (scores (B,k), slot ids (B,k) int32).
        ``alive`` is (N,) shared or (B, N) per row; ``interval`` restricts
        row b to slots ``[starts[b], starts[b] + sizes[b])``. Rows with no
        visible live slot return exactly (-inf, -1)."""
        ...

    def absorb(self, istate: Any, slots: torch.Tensor, keys: torch.Tensor,
               mask: torch.Tensor) -> Any:
        """Incrementally index freshly inserted slab rows (no rebuild)."""
        ...

    def refit(self, istate: Any, keys: torch.Tensor, alive: torch.Tensor,
              rng: torch.Generator) -> Any:
        """Full periodic rebuild (the paper's §2.4 HNSW rebalancing)."""
        ...


@runtime_checkable
class Policy(Protocol):
    """Hit-threshold policy plugin seam."""

    def init_state(self, device: torch.device) -> torch.Tensor:
        ...

    def decide(self, scores: torch.Tensor, state: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """Best-match scores -> (hit mask, updated policy state)."""
        ...

    def update(self, state: torch.Tensor, *, was_positive: torch.Tensor,
               was_hit: torch.Tensor) -> torch.Tensor:
        """Judged-outcome feedback (paper §2.10 control loop)."""
        ...


@dataclasses.dataclass
class CacheRuntime:
    """Everything a semantic cache mutates.

    Leaves: ``state`` (the slab), ``stats`` (counters), ``policy_state``
    (threshold-policy state), ``index_state`` (empty for ExactIndex) and
    ``tenancy`` (per-tenant ring pointers and counters, a
    ``TenancyState``; ``None`` for a single-tenant cache). The JAX
    runtime's ``fusion`` group arrives with the sessions slice."""

    state: CacheState
    stats: CacheStats
    policy_state: torch.Tensor
    index_state: Any
    tenancy: Any = None

    def replace(self, **kw) -> "CacheRuntime":
        return dataclasses.replace(self, **kw)
