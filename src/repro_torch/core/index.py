"""Exact index over the cache slab (paper §2.4), PyTorch port of
``repro.core.index.ExactIndex``.

Brute-force cosine top-k: exact (recall 1.0) and stateless, so its index
state is an empty dataclass. On CUDA tensors the search runs the
hand-written cosine top-k kernel; on CPU tensors its plain version.
``IVFIndex`` waits for the IVF slice.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.similarity import l2_normalize
from repro_torch.core.types import CacheConfig
from repro_torch.kernels import ops, ref
from repro_torch.kernels.cosine_topk import cosine_topk_cuda


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
               interval=None) -> tuple[torch.Tensor, torch.Tensor]:
        """(B,d) x (N,d) under a shared (N,) ``alive`` mask -> (scores (B,k),
        slot ids (B,k) int32). Rows with no visible live slot return exactly
        (-inf, -1)."""
        del istate
        if interval is not None:
            raise NotImplementedError(
                "per-row interval search arrives with the tenancy slice")
        queries = l2_normalize(queries.to(torch.float32))
        if self.backend == "torch":
            return ref.cosine_topk_ref(queries, keys, alive, self.topk)
        if self.backend == "kernel":
            return cosine_topk_cuda(queries, keys, alive, self.topk)
        return ops.cosine_topk(queries, keys, alive, k=self.topk)

    def absorb(self, istate: ExactState, slots: torch.Tensor,
               keys: torch.Tensor, mask: torch.Tensor) -> ExactState:
        del slots, keys, mask
        return istate

    def refit(self, istate: ExactState, keys: torch.Tensor,
              alive: torch.Tensor, rng: torch.Generator) -> ExactState:
        del keys, alive, rng
        return istate
