"""The model's weights, made by the benchmark from ``--seed``.

Every leaf of the port's ``Model`` state dict, by the name and shape that
the configuration gives it, drawn on the device by one
``torch.Generator`` call in the type it is served in (bf16 matrices, f32
norms), at the scales of the port's ``init_params``. Each leaf has a
generator of its own, seeded from ``(seed, name)``, so one leaf can be
made again alone: the program loads the leaves at set-up, and the
reference makes the same leaves again after the program is gone.

Imports nothing of the program.
"""
from __future__ import annotations

import hashlib

import torch


def dtype_of(model: dict) -> torch.dtype:
    return torch.bfloat16 if model.get("dtype", "bfloat16") == "bfloat16" \
        else torch.float32


def padded_vocab(model: dict) -> int:
    m = model.get("vocab_pad_multiple", 512)
    return -(-model["vocab"] // m) * m


def leaves(model: dict) -> list[tuple[str, tuple, torch.dtype, float | None]]:
    """(name, shape, dtype, scale) of every leaf, in a fixed order; scale
    None is a norm weight, all ones. ``model`` holds the port's
    ``ModelConfig`` fields of a dense or moe configuration."""
    dt, f32 = dtype_of(model), torch.float32
    d, h, hkv = model["d_model"], model["n_heads"], model["n_kv_heads"]
    hd, ff, vp = model.get("head_dim", 128), model["d_ff"], padded_vocab(model)
    inter = model.get("moe_interleave", 1)
    g = model["n_layers"] // inter
    moe = model.get("n_experts", 0) > 0
    mlp = inter - 1 if moe else inter
    out = [("embed", (vp, d), dt, 0.02), ("lm_head", (d, vp), dt, d ** -0.5),
           ("final_norm", (d,), f32, None),
           ("blocks.norm1", (g, inter, d), f32, None),
           ("blocks.wq", (g, inter, d, h * hd), dt, d ** -0.5),
           ("blocks.wk", (g, inter, d, hkv * hd), dt, d ** -0.5),
           ("blocks.wv", (g, inter, d, hkv * hd), dt, d ** -0.5),
           ("blocks.wo", (g, inter, h * hd, d), dt, (h * hd) ** -0.5)]
    if mlp > 0:
        out += [("blocks.norm2", (g, mlp, d), f32, None),
                ("blocks.mlp_gate", (g, mlp, d, ff), dt, d ** -0.5),
                ("blocks.mlp_up", (g, mlp, d, ff), dt, d ** -0.5),
                ("blocks.mlp_down", (g, mlp, ff, d), dt, ff ** -0.5)]
    if moe:
        e = model["n_experts"]
        out += [("blocks.moe_norm", (g, d), f32, None),
                ("blocks.router", (g, d, e), dt, d ** -0.5),
                ("blocks.moe_gate", (g, e, d, ff), dt, d ** -0.5),
                ("blocks.moe_up", (g, e, d, ff), dt, d ** -0.5),
                ("blocks.moe_down", (g, e, ff, d), dt, ff ** -0.5)]
    return out


def leaf_seed(seed: int, name: str) -> int:
    """A 63-bit generator seed of ``(seed, name)``; ``seed`` any integer."""
    h = hashlib.sha256(f"{seed}\x1f{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def make_leaf(spec, seed: int, device) -> torch.Tensor:
    """One leaf, drawn on ``device`` in one call."""
    name, shape, dtype, scale = spec
    t = torch.empty(shape, dtype=dtype, device=device)
    if scale is None:
        return t.fill_(1.0)
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, name))
    return t.normal_(0.0, scale, generator=gen)


def make(model: dict, seed: int, device, names=None):
    """Yield ``(name, tensor)`` leaf by leaf (``names``: only those)."""
    for spec in leaves(model):
        if names is None or spec[0] in names:
            yield spec[0], make_leaf(spec, seed, device)
