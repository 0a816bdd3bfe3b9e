"""Shared model layers: RMSNorm, RoPE and M-RoPE, SwiGLU MLP, embeddings
(PyTorch port of ``repro.models.layers``), and hymba's per-branch norm
(``_branch_norm`` of ``repro.models.model``).

The rounding points are the JAX package's: ``rms_norm`` computes in f32
and casts back to the input's dtype; ``apply_rope`` and ``apply_mrope``
multiply the input by f32 cos/sin (a bf16 input is promoted to f32, as
jnp promotes it) and cast back.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32)).to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, f32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x (..., S, H, D); positions (..., S) integer -> rotated x."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # (D/2,)
    angles = positions[..., None].to(torch.float32) * freqs       # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                         # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """M-RoPE (qwen2-vl): positions3 (..., S, 3) = (t, h, w) per token.

    The head_dim/2 frequency slots are split into three contiguous
    sections; each section rotates by its own coordinate. Text tokens carry
    t == h == w, for which M-RoPE is standard RoPE."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} must sum to head_dim/2 "
                         f"= {half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # (D/2,)
    sec_id = torch.cat([torch.full((n,), i, dtype=torch.long,
                                   device=x.device)
                        for i, n in enumerate(sections)])         # (D/2,)
    pos = positions3.to(torch.float32)[..., sec_id]               # (..., S, D/2)
    angles = pos * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def positionize(config: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """Positions in the arch's expected rank: (..., S) for standard RoPE,
    (..., S, 3) for M-RoPE, where (..., S) text positions become t = h = w.
    As in JAX, positions whose last axis is already 3 are taken as
    triples."""
    if config.mrope and positions.shape[-1] != 3:
        positions = torch.stack([positions] * 3, dim=-1)
    return positions


def rope_for(config: ModelConfig, x: torch.Tensor, positions: torch.Tensor
             ) -> torch.Tensor:
    if config.mrope:
        return apply_mrope(x, positions, config.rope_theta,
                           config.mrope_sections)
    return apply_rope(x, positions, config.rope_theta)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: down( silu(x @ gate) * (x @ up) )."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def _branch_norm(x: torch.Tensor) -> torch.Tensor:
    """Parameter-free per-branch RMS normalization (hymba's output fusion
    of its attention and SSM branches), f32 out."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return x32 * torch.rsqrt(var + 1e-6)


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(x: torch.Tensor, head: torch.Tensor, logical_vocab: int
            ) -> torch.Tensor:
    """Project to the padded vocab; the padding columns are set to -1e9
    (not -inf), as in the JAX package."""
    logits = x @ head
    if logits.shape[-1] > logical_vocab:
        logits[..., logical_vocab:] = -1e9
    return logits
