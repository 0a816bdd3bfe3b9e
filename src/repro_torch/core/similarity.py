"""Cosine similarity and masked top-k — the scoring primitive (paper §2.6),
PyTorch port of ``repro.core.similarity``.

Stored keys are L2-normalized at insert time, so scoring a normalized query
against the slab is one ``(B, d) @ (d, N)`` product. These are the plain
tensor versions; the CUDA kernel in ``repro_torch.kernels`` computes the
same contract on the card.
"""
from __future__ import annotations

import torch

NEG_INF = float("-inf")


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12
                 ) -> torch.Tensor:
    """L2-normalize along ``dim`` (zero vectors map to zero)."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def cosine_similarity(u: torch.Tensor, v: torch.Tensor, eps: float = 1e-12
                      ) -> torch.Tensor:
    """Elementwise cosine similarity along the last axis (paper §2.6):
    ``u·v / max(|u||v|, eps)``."""
    un = torch.linalg.vector_norm(u, dim=-1)
    vn = torch.linalg.vector_norm(v, dim=-1)
    return torch.sum(u * v, dim=-1) / torch.clamp(un * vn, min=eps)


def cosine_scores(queries: torch.Tensor, keys: torch.Tensor,
                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """Batched scores: (B, d) x (N, d) -> (B, N) f32; invalid slots get -inf.

    ``valid`` is (N,) shared by the batch or (B, N) per row. int8 keys are
    the uniform slab quantization and dequantize by 1/127."""
    if keys.dtype == torch.int8:
        keys = keys.to(torch.float32) / 127.0
    scores = queries.to(torch.float32) @ keys.to(torch.float32).T
    if valid is not None:
        mask = valid if valid.dim() == 2 else valid[None, :]
        scores = torch.where(mask, scores,
                             torch.full_like(scores, NEG_INF))
    return scores


def interval_visibility(alive: torch.Tensor, starts: torch.Tensor,
                        sizes: torch.Tensor) -> torch.Tensor:
    """Expand per-row interval operands into a dense (B, N) visibility mask:
    row ``b`` sees the alive slots in ``[starts[b], starts[b] + sizes[b])``.
    ``alive`` is (N,) shared or already-per-row (B, N)."""
    cols = torch.arange(alive.shape[-1], dtype=torch.int32,
                        device=alive.device)[None, :]
    inside = (cols >= starts[:, None]) & (cols < (starts + sizes)[:, None])
    return (alive if alive.dim() == 2 else alive[None, :]) & inside


def masked_topk(scores: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis: (values (..., k), int64 indices (..., k)).

    Ties go to the lowest index, as ``jax.lax.top_k`` does. ``torch.topk``
    does not promise that, so this is a stable descending sort."""
    k = min(k, scores.shape[-1])
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def best_match(scores: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Argmax and max over the last axis: (B, N) -> ((B,) int32, (B,));
    of tied maxima the first, as ``jnp.argmax`` takes it."""
    return (torch.argmax(scores, dim=-1).to(torch.int32),
            torch.amax(scores, dim=-1))
