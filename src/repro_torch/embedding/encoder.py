"""MiniLM-class sentence-embedding encoder (PyTorch port of
``repro.embedding.encoder``; the paper's "local ONNX model" path, §2.2).

A 6-layer bidirectional transformer (384-dim, 12 heads: the
all-MiniLM-L6-v2 geometry of the paper's experiments) with mean pooling
over non-pad positions and L2 normalization, the paper's "normalized and
pooled" recipe. Weights are drawn from a seeded generator (no checkpoint
downloads); no serve path calls the encoder, in either package: the
paper-metric runs embed with the deterministic ``HashEmbedder``.

The arithmetic is the reference's, step for step, in plain PyTorch (the
reference's einsums run outside any Pallas kernel): pre-norm blocks on
``models.layers.rms_norm``, scores over ``head_dim ** 0.5``, keys at or
past a row's length set to -1e30 (so a row of length 0 attends uniformly,
pools to zero and comes out zero through the 1e-12 floor, never NaN), the
tanh form of GELU (``jax.nn.gelu``'s default), a final ``rms_norm``, the
mean over valid positions (divisor at least 1) and the L2 normalization.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.types import resolve_device
from repro_torch.models.layers import rms_norm

MASKED = -1e30   # score of a key at or past its row's length


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab: int = 32768
    d_model: int = 384
    n_layers: int = 6
    n_heads: int = 12
    d_ff: int = 1536
    max_len: int = 256

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


MINILM_L6 = EncoderConfig()


def init_encoder_params(generator: torch.Generator,
                        cfg: EncoderConfig = MINILM_L6, *,
                        device="cuda") -> dict:
    """The reference's parameter tree with its scales: ``embed`` (V, d),
    ``pos_embed`` (max_len, d), ``blocks`` of per-layer leaves stacked on
    a leading (n_layers,) axis (``norm1``, ``wqkv`` (d, 3d), ``wo``,
    ``norm2``, ``w1`` (d, d_ff), ``w2``) and ``final_norm``, all f32 on
    ``device``, drawn from ``generator`` (which must live there). The
    numbers differ from JAX's; tests carry JAX's across
    (``models.convert.tree_from_jax``)."""
    dev = resolve_device(device)
    d, ff, l = cfg.d_model, cfg.d_ff, cfg.n_layers

    def nrm(shape, scale):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=dev) * scale

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    return {
        "embed": nrm((cfg.vocab, d), 0.02),
        "pos_embed": nrm((cfg.max_len, d), 0.02),
        "blocks": {
            "norm1": ones((l, d)),
            "wqkv": nrm((l, d, 3 * d), d ** -0.5),
            "wo": nrm((l, d, d), d ** -0.5),
            "norm2": ones((l, d)),
            "w1": nrm((l, d, ff), d ** -0.5),
            "w2": nrm((l, ff, d), ff ** -0.5),
        },
        "final_norm": ones((d,)),
    }


def encode(params: dict, tokens: torch.Tensor, lengths: torch.Tensor,
           cfg: EncoderConfig = MINILM_L6) -> torch.Tensor:
    """tokens (B, L) int, lengths (B,) int -> (B, d) f32 unit embeddings
    (a row of length 0 gives zeros). ``L`` may not exceed ``cfg.max_len``
    (ValueError; the reference fails on a broadcast)."""
    b, l = tokens.shape
    if l > cfg.max_len:
        raise ValueError(f"{l} token positions exceed the encoder's max_len "
                         f"{cfg.max_len}")
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    mask = torch.arange(l, device=tokens.device)[None, :] < lengths[:, None]
    hidden = ~mask[:, None, None, :]                          # (B, 1, 1, L)
    x = params["embed"][tokens] + params["pos_embed"][:l][None]
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        xn = rms_norm(x, blocks["norm1"][i])
        q, k, v = (t.reshape(b, l, h, hd) for t in
                   (xn @ blocks["wqkv"][i]).split(d, dim=-1))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / (hd ** 0.5)
        p = torch.softmax(s.masked_fill(hidden, MASKED), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, l, d)
        x = x + o @ blocks["wo"][i]
        xn = rms_norm(x, blocks["norm2"][i])
        y = F.gelu(xn @ blocks["w1"][i], approximate="tanh")
        x = x + y @ blocks["w2"][i]
    x = rms_norm(x, params["final_norm"])
    m = mask[..., None].to(x.dtype)
    pooled = torch.sum(x * m, dim=1) / torch.clamp_min(torch.sum(m, dim=1),
                                                       1.0)
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / torch.clamp_min(norm, 1e-12)
