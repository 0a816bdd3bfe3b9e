"""Exact index over the cache slab (paper §2.4), PyTorch port of
``repro.core.index.ExactIndex``.

Brute-force cosine top-k: exact (recall 1.0) and stateless, so its index
state is an empty dataclass. On CUDA tensors the search runs the
hand-written cosine top-k kernels (shared mask, per-row interval or dense
per-row mask); on CPU tensors their plain versions. ``IVFIndex`` waits for
the IVF slice.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.similarity import interval_visibility, l2_normalize
from repro_torch.core.types import CacheConfig
from repro_torch.kernels import ops, ref
from repro_torch.kernels.cosine_topk import (cosine_topk_cuda,
                                             cosine_topk_interval_cuda,
                                             cosine_topk_masked_cuda)


@dataclasses.dataclass
class ExactState:
    """Empty index state: brute-force scoring reads the slab directly."""


@dataclasses.dataclass(frozen=True)
class ExactIndex:
    """Exact scoring. ``backend`` is ``'auto'`` (follow the device of the
    tensors), ``'torch'`` (the plain version on any device) or
    ``'kernel'`` (the CUDA kernel; raises on CPU tensors)."""

    topk: int = 4
    backend: str = "auto"

    def __post_init__(self):
        if self.backend not in ("auto", "torch", "kernel"):
            raise ValueError(f"unknown backend {self.backend!r}")

    def init(self, config: CacheConfig) -> ExactState:
        del config
        return ExactState()

    def search(self, istate: ExactState, queries: torch.Tensor,
               keys: torch.Tensor, alive: torch.Tensor, *,
               interval: tuple[torch.Tensor, torch.Tensor] | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(B,d) x (N,d) -> (scores (B,k), slot ids (B,k) int32).

        ``alive`` is (N,), one mask for the whole batch, or (B, N) per row.
        ``interval`` = per-row ``(starts, sizes)`` operands restricting each
        row to a contiguous slot range on top of a shared (N,) ``alive``:
        the tenancy path, which stays on the interval kernel with O(B)
        operands. An interval on top of a (B, N) ``alive`` is folded into
        the mask, so the restriction is never dropped. Rows with no visible
        live slot return exactly (-inf, -1)."""
        del istate
        queries = l2_normalize(queries.to(torch.float32))
        if interval is not None and alive.dim() == 2:
            alive = interval_visibility(alive, *interval)
            interval = None
        if self.backend == "torch":
            if interval is not None:
                return ref.cosine_topk_interval_ref(queries, keys, alive,
                                                    *interval, self.topk)
            return ref.cosine_topk_ref(queries, keys, alive, self.topk)
        if self.backend == "kernel":
            if interval is not None:
                return cosine_topk_interval_cuda(queries, keys, alive,
                                                 *interval, self.topk)
            if alive.dim() == 2:
                return cosine_topk_masked_cuda(queries, keys, alive,
                                               self.topk)
            return cosine_topk_cuda(queries, keys, alive, self.topk)
        if interval is not None:
            return ops.cosine_topk_interval(queries, keys, alive, *interval,
                                            k=self.topk)
        return ops.cosine_topk(queries, keys, alive, k=self.topk)

    def absorb(self, istate: ExactState, slots: torch.Tensor,
               keys: torch.Tensor, mask: torch.Tensor) -> ExactState:
        del slots, keys, mask
        return istate

    def refit(self, istate: ExactState, keys: torch.Tensor,
              alive: torch.Tensor, rng: torch.Generator) -> ExactState:
        del keys, alive, rng
        return istate
