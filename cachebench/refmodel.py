"""The plain reference of the miss path's model, and its lower-precision
control.

The decoder of the configuration, in float32 with TF32 off, with no
kernel, cache or batching of its own: embeddings; per layer an RMSNorm,
RoPE attention with grouped KV heads, then a SwiGLU MLP or a top-k
mixture of experts with GShard capacity dispatch (tokens past an expert's
capacity keep their residual only); a final norm and the head. It follows
what the served model is meant to compute for a batch of misses, which a
decode runs as one prefill of the padded prompts and then one step a
token: capacity is shared by the tokens of one forward, so the experts
dispatch the prompts' tokens together (row after row) and each later
position's tokens of the batch together. Attention runs over the whole
sequence under a causal mask, which is what prefill and decode through a
cache compute.

``teacher_logits`` feeds each prompt with the tokens the program served
and returns the reference's logits where each served token was chosen,
so ``gaps`` says by how far each served token's logit lies below the
reference's best. ``precision="fp8"`` is the control: every matrix
product takes its operands rounded to float8 e4m3 with a scale a row
(activations) and a column (weights), the step below bf16.

With a mixture of experts the top-k choice is discontinuous: a rounding
(bf16's included) that flips a near tie between two experts moves the
token's output by a whole expert's, and where buffers fill, it moves
which tokens an expert drops. So ``gaps`` is read two ways: the widest
gap, and the share of served tokens that lie more than ``GAP_EPS`` below
the best.

Imports nothing of the program; the weights come from ``weights``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from cachebench import weights as wlib

F8 = torch.float8_e4m3fn
F8_MAX = 448.0
#: a served token more than this below the reference's best disagrees:
#: past what bf16 rounding alone gives a dense model (yi-6b's widest gap
#: over a dozen seeds reads 0.086)
GAP_EPS = 0.1


def _f8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to e4m3 with one scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    s = amax / F8_MAX
    return (x / s).to(F8).to(torch.float32) * s


def _mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return _f8(x, -1) @ _f8(w, -2)
    return x @ w


def _rms(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) * w


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, L, H, D), pos (L,): rotate-half RoPE."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = pos.to(torch.float32)[:, None] * freqs
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class Weights:
    """The leaves, made again from the seed on ``device`` (bf16 as
    served); each matrix goes to f32 where it is used."""

    def __init__(self, model: dict, seed: int, device):
        self.t = dict(wlib.make(model, seed, device))

    def __call__(self, name: str, *idx) -> torch.Tensor:
        t = self.t[name]
        return (t[idx] if idx else t).to(torch.float32)


def _groups(b: int, l_prompt: int, l_total: int, device) -> list:
    """Token indices (into the flat (B * L) sequence) of each forward of
    the decode: the prompts' tokens row after row, then each later
    position's tokens of all rows."""
    idx = torch.arange(b * l_total, device=device).view(b, l_total)
    return [idx[:, :l_prompt].reshape(-1)] + \
        [idx[:, p] for p in range(l_prompt, l_total)]


def _moe(xn, w, g, model, groups, precision):
    """Top-k experts with capacity, over each group of tokens."""
    e, k = model["n_experts"], model["moe_topk"]
    cf = model.get("capacity_factor", 1.25)
    logits = _mm(xn, w("blocks.router", g), precision)
    probs = torch.softmax(logits, dim=-1)
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = ranked[:, :k] / ranked[:, :k].sum(-1, keepdim=True).clamp_min(
        1e-9)
    experts = order[:, :k]
    keep = torch.zeros_like(experts, dtype=torch.bool)
    for grp in groups:
        cap = max(int(math.ceil(grp.numel() * k / e * cf)), 1)
        ex = experts[grp]
        counts = torch.zeros(e, dtype=torch.long, device=xn.device)
        rank = torch.empty_like(ex)
        for j in range(k):                              # choice-major ranks
            oh = F.one_hot(ex[:, j], e)
            r = torch.cumsum(oh, 0) - 1 + counts[None]
            rank[:, j] = (r * oh).sum(-1)
            counts += oh.sum(0)
        keep[grp] = rank < cap
    y = torch.zeros_like(xn)
    for ei in range(e):
        sel = (experts == ei) & keep
        tok, ch = sel.nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = xn[tok]
        h = F.silu(_mm(xe, w("blocks.moe_gate", g, ei), precision)) * \
            _mm(xe, w("blocks.moe_up", g, ei), precision)
        ye = _mm(h, w("blocks.moe_down", g, ei), precision)
        y.index_add_(0, tok, gates[tok, ch, None] * ye)
    return y


@torch.no_grad()
def teacher_logits(w: Weights, model: dict, prompts: torch.Tensor,
                   served: torch.Tensor, *, precision: str = "f32"
                   ) -> torch.Tensor:
    """prompts (B, P) and the served tokens (B, N), long, on w's device.
    Returns the logits (B, N, V) f32 at the positions that chose each
    served token."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b, p = prompts.shape
    n = served.shape[1]
    seq = torch.cat([prompts, served[:, :n - 1]], dim=1)
    l = seq.shape[1]
    dev = prompts.device
    h, hkv = model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim", 128)
    theta = float(model.get("rope_theta", 10000.0))
    moe = model.get("n_experts", 0) > 0
    x = w("embed")[seq]                                   # (B, L, d)
    pos = torch.arange(l, device=dev)
    mask = torch.ones(l, l, dtype=torch.bool, device=dev).tril()
    groups = _groups(b, p, l, dev)
    for g in range(model["n_layers"]):
        xn = _rms(x, w("blocks.norm1", g, 0))
        q = _mm(xn, w("blocks.wq", g, 0), precision).view(b, l, h, hd)
        kk = _mm(xn, w("blocks.wk", g, 0), precision).view(b, l, hkv, hd)
        v = _mm(xn, w("blocks.wv", g, 0), precision).view(b, l, hkv, hd)
        q, kk = _rope(q, pos, theta), _rope(kk, pos, theta)
        rep = h // hkv
        kk = kk.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(hd)
        s = s.masked_fill(~mask, float("-inf"))
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
        x = x + _mm(o.reshape(b, l, h * hd), w("blocks.wo", g, 0),
                    precision)
        if moe:
            xn = _rms(x, w("blocks.moe_norm", g)).reshape(b * l, -1)
            x = x + _moe(xn, w, g, model, groups,
                         precision).view(b, l, -1)
        else:
            xn = _rms(x, w("blocks.norm2", g, 0))
            hmid = F.silu(_mm(xn, w("blocks.mlp_gate", g, 0), precision)) \
                * _mm(xn, w("blocks.mlp_up", g, 0), precision)
            x = x + _mm(hmid, w("blocks.mlp_down", g, 0), precision)
    xs = _rms(x[:, p - 1:], w("final_norm"))
    logits = _mm(xs, w("lm_head"), precision)
    if logits.shape[-1] > model["vocab"]:
        logits[..., model["vocab"]:] = -1e9
    return logits


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """(B, N) how far each token's reference logit lies below the
    reference's best at its position (0 where it is the best)."""
    best = ref_logits.max(-1).values
    return best - ref_logits.gather(-1, tokens[..., None])[..., 0]
