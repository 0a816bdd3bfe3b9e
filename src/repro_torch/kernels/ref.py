"""Plain PyTorch versions of the port's kernels (PyTorch port of
``repro.kernels.ref``).

They define the numerical contract. The kernel wrappers take them for CPU
tensors, and ``chip_smoke.py`` holds each CUDA kernel against them on the
card.
"""
from __future__ import annotations

import torch

from repro_torch.core.similarity import NEG_INF, cosine_scores, masked_topk


def cosine_topk_ref(queries: torch.Tensor, keys: torch.Tensor,
                    valid: torch.Tensor, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact masked cosine top-k.

    Args:
      queries: (B, d) float32, assumed L2-normalized.
      keys: (N, d) float32, bfloat16 or int8. int8 keys are the uniform slab
        quantization (round(normalized * 127)) and are divided by 127
        before scoring.
      valid: (N,) bool aliveness mask shared by the batch, or (B, N) bool.
      k: neighbours to return.
    Returns:
      (scores (B, k) f32 sorted descending, slot ids (B, k) int32). Ties go
      to the lowest slot id. Slots past the visible ones come back as
      exactly (-inf, -1), so an all-masked row is all (-inf, -1).
    """
    scores = cosine_scores(queries, keys, valid)
    vals, idx = masked_topk(scores, k)
    idx = torch.where(vals > NEG_INF, idx, torch.full_like(idx, -1))
    return vals, idx.to(torch.int32)
