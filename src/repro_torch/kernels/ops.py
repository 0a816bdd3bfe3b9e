"""Dispatch of the port's kernels by the device of their tensors (PyTorch
port of ``repro.kernels.ops``): CUDA tensors go to the hand-written kernel,
CPU tensors to its plain PyTorch version in ``ref``. There is no switch
that sends CUDA tensors to the plain version; ``chip_smoke.py`` calls it
directly to compare.

Per-row visibility dispatches as in the JAX package:
  * ``valid`` (N,)    -> the shared-mask kernel (single-tenant path);
  * interval operands -> the interval kernel, O(B) operands (tenancy);
  * ``valid`` (B, N)  -> the dense-mask kernel (general per-row masks).

``ivf_topk`` dispatches the IVF candidate kernel the same way, with the
``backend`` override of ``IVFIndex``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.cosine_topk import (check_args, check_interval_args,
                                             check_masked_args,
                                             cosine_topk_cuda,
                                             cosine_topk_interval_cuda,
                                             cosine_topk_masked_cuda)
from repro_torch.kernels.ivf_topk import check_args as check_ivf_args
from repro_torch.kernels.ivf_topk import ivf_topk_cuda

BACKENDS = ("auto", "torch", "kernel")


def cosine_topk(queries: torch.Tensor, keys: torch.Tensor, valid: torch.Tensor,
                *, k: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked cosine top-k; ``valid`` is (N,) shared by the batch or (B, N)
    per row."""
    masked = valid.dim() == 2
    if queries.device.type == "cuda":
        if masked:
            return cosine_topk_masked_cuda(queries, keys, valid, k)
        return cosine_topk_cuda(queries, keys, valid, k)
    if masked:
        check_masked_args(queries, keys, valid, k)
    else:
        check_args(queries, keys, valid, k)
    return ref.cosine_topk_ref(queries, keys, valid, k)


def cosine_topk_interval(queries: torch.Tensor, keys: torch.Tensor,
                         valid: torch.Tensor, starts: torch.Tensor,
                         sizes: torch.Tensor, *, k: int = 4
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Row ``b`` sees ``valid`` within ``[starts[b], starts[b] + sizes[b])``
    — the tenancy path."""
    if queries.device.type == "cuda":
        return cosine_topk_interval_cuda(queries, keys, valid, starts, sizes,
                                         k)
    check_interval_args(queries, keys, valid, starts, sizes, k)
    return ref.cosine_topk_interval_ref(queries, keys, valid, starts, sizes,
                                        k)


def ivf_topk(queries: torch.Tensor, keys: torch.Tensor, cand: torch.Tensor,
             *, k: int = 4, backend: str = "auto"
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """IVF candidate top-k: ``cand`` is (B, M) int32 candidate slot ids, -1
    marking every invisible candidate (``IVFIndex.candidates`` folds bucket
    validity, aliveness, tenancy and per-row duplicates into the ids).
    ``backend`` is ``'auto'`` (follow the device of the tensors),
    ``'torch'`` (the plain version on any device) or ``'kernel'`` (the CUDA
    kernel; raises on CPU tensors)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "kernel" or (backend == "auto"
                               and queries.device.type == "cuda"):
        return ivf_topk_cuda(queries, keys, cand, k)
    check_ivf_args(queries, keys, cand, k)
    return ref.ivf_topk_ref(queries, keys, cand, k)
