"""Dispatch of the port's kernels by the device of their tensors (PyTorch
port of ``repro.kernels.ops``): CUDA tensors go to the hand-written kernel,
CPU tensors to its plain PyTorch version in ``ref``. There is no switch
that sends CUDA tensors to the plain version; ``chip_smoke.py`` calls it
directly to compare.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.cosine_topk import check_args, cosine_topk_cuda


def cosine_topk(queries: torch.Tensor, keys: torch.Tensor, valid: torch.Tensor,
                *, k: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked cosine top-k under a shared (N,) ``valid`` mask."""
    if queries.device.type == "cuda":
        return cosine_topk_cuda(queries, keys, valid, k)
    check_args(queries, keys, valid, k)
    return ref.cosine_topk_ref(queries, keys, valid, k)
