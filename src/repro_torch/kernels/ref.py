"""Plain PyTorch versions of the port's kernels (PyTorch port of
``repro.kernels.ref``): the cosine top-k in its three mask forms and the IVF
candidate top-k.

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


def interval_mask(starts: torch.Tensor, sizes: torch.Tensor, n: int
                  ) -> torch.Tensor:
    """(B,) interval operands -> (B, N) bool visibility mask: row ``b`` sees
    slots ``[starts[b], starts[b] + sizes[b])``. The plain form of the
    per-row mask the interval kernel never builds."""
    cols = torch.arange(n, dtype=torch.int32, device=starts.device)[None, :]
    return (cols >= starts[:, None]) & (cols < (starts + sizes)[:, None])


def cosine_topk_interval_ref(queries: torch.Tensor, keys: torch.Tensor,
                             valid: torch.Tensor, starts: torch.Tensor,
                             sizes: torch.Tensor, k: int
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the interval kernel (the tenancy path): the dense
    (B, N) mask of shared aliveness and per-row interval, then the exact
    top-k. Rows with ``sizes[b] == 0`` return (-inf, -1)."""
    mask = valid[None, :] & interval_mask(starts, sizes, keys.shape[0])
    return cosine_topk_ref(queries, keys, mask, k)


_IVF_ROWS_PER_CHUNK = 1 << 16   # slab rows gathered at a time (100 MB f32)


def ivf_topk_ref(queries: torch.Tensor, keys: torch.Tensor,
                 cand: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the IVF candidate kernel: score each row's visible
    candidates, then the exact top-k over candidate positions.

    Args:
      queries: (B, d) float32, assumed L2-normalized.
      keys: (N, d) slab, float32, bfloat16 or int8 (divided by 127).
      cand: (B, M) int32 candidate slot ids. An id is visible when
        ``0 <= id < N``: ``IVFIndex.candidates`` marks every invisible
        candidate -1 and never gives an id >= N; one is treated as invisible,
        as the kernel does (the JAX oracle would clamp it onto slot N-1).
      k: neighbours to return, at most M.
    Returns:
      (scores (B, k) f32 sorted descending, slot ids (B, k) int32). Ties go
      to the lowest candidate position, as ``lax.top_k`` over positions
      does, not to the lowest slot id. Entries past the visible ids are
      exactly (-inf, -1).

    Only the visible (row, position) pairs are gathered and scored, a chunk
    of slab rows at a time, and scattered into a (B, M) -inf matrix, so the
    (B, M, d) tensor of the JAX oracle is never built.
    """
    b, m = cand.shape
    visible = (cand >= 0) & (cand < keys.shape[0])
    rows, pos = visible.nonzero(as_tuple=True)
    scores = torch.full((b, m), NEG_INF, dtype=torch.float32,
                        device=cand.device)
    for i in range(0, rows.numel(), _IVF_ROWS_PER_CHUNK):
        r = rows[i:i + _IVF_ROWS_PER_CHUNK]
        p = pos[i:i + _IVF_ROWS_PER_CHUNK]
        gathered = keys[cand[r, p].to(torch.int64)].to(torch.float32)
        if keys.dtype == torch.int8:
            gathered = gathered / 127.0
        scores[r, p] = (queries[r].to(torch.float32) * gathered).sum(-1)
    vals, order = masked_topk(scores, k)
    ids = torch.gather(cand, 1, order)
    ids = torch.where(vals > NEG_INF, ids, torch.full_like(ids, -1))
    return vals, ids.to(torch.int32)
