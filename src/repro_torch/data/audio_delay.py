"""MusicGen delay-pattern codec (Copet et al. 2023, §2.2): a numpy-only
copy of ``repro.data.audio_delay``.

EnCodec emits K parallel codebooks per frame; MusicGen's *delay pattern*
offsets codebook k by k steps so a single autoregressive decoder models the
joint distribution: at step t the model predicts codebook k's token for
frame t-k. ``apply_delay``/``remove_delay`` convert between frame-parallel
(B, T, K) token grids and the delayed (B, T+K-1, K) training/serving layout,
padding with ``pad_id``.
"""
from __future__ import annotations

import numpy as np


def apply_delay(tokens: np.ndarray, pad_id: int = 0) -> np.ndarray:
    """(B, T, K) frame-parallel -> (B, T+K-1, K) delayed."""
    b, t, k = tokens.shape
    out = np.full((b, t + k - 1, k), pad_id, dtype=tokens.dtype)
    for cb in range(k):
        out[:, cb:cb + t, cb] = tokens[:, :, cb]
    return out


def remove_delay(delayed: np.ndarray, n_frames: int, pad_id: int = 0
                 ) -> np.ndarray:
    """(B, T+K-1, K) delayed -> (B, T, K) frame-parallel."""
    b, _, k = delayed.shape
    out = np.full((b, n_frames, k), pad_id, dtype=delayed.dtype)
    for cb in range(k):
        out[:, :, cb] = delayed[:, cb:cb + n_frames, cb]
    return out
