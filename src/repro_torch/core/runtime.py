"""CacheRuntime — the one object that holds all semantic-cache state, plus
the typed plugin seams (PyTorch port of ``repro.core.runtime``).

``CacheRuntime`` bundles the slab, the counters, the policy state and the
index state, so a serve step is a function ``runtime -> runtime`` and a
checkpoint is ``save(runtime)``. Index and policy implementations are
interchangeable behind the ``Index`` / ``Policy`` protocols; a stateless
index (``ExactIndex``) carries an empty state, ``IVFIndex`` an ``IVFState``
(centroids and bucket tables); a context-fused cache adds its fusion
weights.
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

    def init(self, config: CacheConfig, device=None) -> Any:
        """Fresh index state on ``device``, with static shapes derived from
        ``config``."""
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
    (threshold-policy state), ``index_state`` (empty for ExactIndex, an
    ``IVFState`` for IVFIndex),
    ``tenancy`` (per-tenant ring pointers and counters, a
    ``TenancyState``; ``None`` for a single-tenant cache) and ``fusion``
    (context-fusion weights, a ``FusionState``; ``None`` for a single-turn
    cache)."""

    state: CacheState
    stats: CacheStats
    policy_state: torch.Tensor
    index_state: Any
    tenancy: Any = None
    fusion: Any = None

    def replace(self, **kw) -> "CacheRuntime":
        return dataclasses.replace(self, **kw)


def _joined(groups: list, device: torch.device, join):
    """One leaf group from the shards' groups (dataclasses of tensors, or
    None): each leaf's parts moved to ``device`` and joined."""
    if groups[0] is None:
        return None
    return type(groups[0])(**{
        f.name: join([getattr(g, f.name).to(device) for g in groups])
        for f in dataclasses.fields(groups[0])})


def _moved(group, device: torch.device):
    """A leaf group (a dataclass of tensors, a tensor, or None) on
    ``device``."""
    if group is None or isinstance(group, torch.Tensor):
        return None if group is None else group.to(device)
    return type(group)(**{f.name: getattr(group, f.name).to(device)
                          for f in dataclasses.fields(group)})


_CLOCK = ("ptr", "n_inserts")


@dataclasses.dataclass(frozen=True)
class ShardedRuntime:
    """The runtime of a ``DistributedCache``: one ``CacheRuntime`` a shard,
    each on its shard's device, kept between calls (DESIGN.md §19.3).

    Shard ``i`` holds its ``local_capacity`` slab rows, its (C, ...) index
    leaves and its (T,) tenancy row. Every shard holds a copy of the
    replicated leaves (stats, policy state, fusion weights and the ``ptr``
    / ``n_inserts`` clock); shard 0's is the cache's, and it lives on the
    controller's device. The properties give the global, shard-major view
    of the JAX package's runtime on the controller's device: the
    replicated leaves are shard 0's own tensors, the sharded ones are
    assembled, a copy that no write reaches back from. ``gather`` gives all
    of it on any device."""

    shards: tuple[CacheRuntime, ...]

    @property
    def device(self) -> torch.device:
        return self.shards[0].state.valid.device

    @property
    def stats(self) -> CacheStats:
        return self.shards[0].stats

    @property
    def policy_state(self) -> torch.Tensor:
        return self.shards[0].policy_state

    @property
    def fusion(self) -> Any:
        return self.shards[0].fusion

    @property
    def state(self) -> CacheState:
        return self._state(self.device)

    @property
    def index_state(self) -> Any:
        return _joined([s.index_state for s in self.shards], self.device,
                       torch.cat)

    @property
    def tenancy(self) -> Any:
        return _joined([s.tenancy for s in self.shards], self.device,
                       torch.stack)

    def _state(self, device: torch.device) -> CacheState:
        first = self.shards[0].state
        return CacheState(**{
            f.name: getattr(first, f.name).to(device) if f.name in _CLOCK
            else torch.cat([getattr(s.state, f.name).to(device)
                            for s in self.shards])
            for f in dataclasses.fields(CacheState)})

    def gather(self, device=None) -> CacheRuntime:
        """The global runtime on ``device`` (default: the controller's):
        each shard's rows read from its device into the shard-major
        layout, index leaves stacked (S·C, ...), tenancy leaves (S, T),
        shard 0's replicated leaves."""
        dev = self.device if device is None else torch.device(device)
        first = self.shards[0]
        return CacheRuntime(
            state=self._state(dev), stats=_moved(first.stats, dev),
            policy_state=first.policy_state.to(dev),
            index_state=_joined([s.index_state for s in self.shards], dev,
                                torch.cat),
            tenancy=_joined([s.tenancy for s in self.shards], dev,
                            torch.stack),
            fusion=_moved(first.fusion, dev))
