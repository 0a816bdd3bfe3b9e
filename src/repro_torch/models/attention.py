"""Attention substrate of the model-backed miss path (PyTorch port of
``repro.models.attention``): prefill attention, the KV cache and
single-token decode attention against it.

``blockwise_attention`` and ``decode_attention`` keep the JAX functions'
signatures and layouts and dispatch through ``kernels.ops`` by the device
of the tensors: on CUDA the hand-written flash-attention and
decode-attention kernels, on the CPU their plain versions. The JAX
package's prefill runs the pure-jnp ``blockwise_attention``, which computes
what its Pallas kernel computes; the port's kernels follow the Pallas
contracts (a row with nothing visible is 0), which agree with the jnp
functions on every row that sees at least one key, as every row of the
model's causal prefill and decode does.

Unlike JAX's, the port's cache is updated in place: ``cache_write`` writes
the new token's K/V into the layer's cache tensors (a copy into one slot)
and returns them, so a decode step allocates no new cache.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.types import resolve_device
from repro_torch.kernels import ops


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        n_sink: int = 0, scale: float | None = None
                        ) -> torch.Tensor:
    """q (B, Lq, H, D), RoPE applied; k/v (B, Lk, HKV, D); query offset
    ``Lk - Lq`` (ends aligned); with a window, keys ``j < n_sink`` stay
    visible (attention sinks). The (Lq, Lk) scores never reach device
    memory on CUDA."""
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               n_sink=n_sink, scale=scale)


@dataclasses.dataclass
class KVCache:
    """Per-model KV cache, layers stacked on the leading axis.

    k/v (L, B, S, HKV, D); ``slot_pos`` (S,) int32 = the absolute position
    stored in each slot (-1 = empty); a cache smaller than the sequence is
    a ring (slot = pos % S). ``pos`` is the next absolute position to
    write, a host int (JAX keeps a 0-d array). The quantized variant holds
    int8 k/v with per-(token, head) f32 scales (L, B, S, HKV); unquantized
    caches have none (JAX keeps zero-size placeholders).
    """

    k: torch.Tensor
    v: torch.Tensor
    slot_pos: torch.Tensor
    pos: int
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def size(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k.dtype == torch.int8


def init_kv_cache(n_layers: int, batch: int, size: int, n_kv: int,
                  head_dim: int, dtype=torch.bfloat16, quantized: bool = False,
                  device=None) -> KVCache:
    """Empty caches on ``device``: ``None`` means CUDA, as at every entry
    point (``resolve_device``), and raises without it."""
    device = resolve_device(device)
    shape = (n_layers, batch, size, n_kv, head_dim)
    slot_pos = torch.full((size,), -1, dtype=torch.int32, device=device)
    if quantized:
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            slot_pos=slot_pos, pos=0,
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                device=device))
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   slot_pos=slot_pos, pos=0)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(..., head) symmetric int8 over the head_dim axis.
    x (..., D) -> (int8 (..., D), scale (...) f32). The scale is
    ``max(absmax, 1e-8) * (1 / 127)``: what the JAX package's ``/ 127.0``
    computes inside its jitted decode step, where XLA turns the division by
    a constant into a multiplication (1 ulp apart on some rows, enough to
    flip a rounding of ``x / scale``)."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1)
    scale = torch.clamp_min(absmax, 1e-8) * (1.0 / 127.0)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, slot_pos: torch.Tensor, pos: int,
                     *, window: int | None = None, n_sink: int = 0,
                     scale: float | None = None,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Single-token attention over every live cache slot (order-free: the
    ring never needs unrotating because visibility uses ``slot_pos``).
    q (B, 1, H, D) with RoPE at ``pos``; k/v one layer's (B, S, HKV, D)
    cache with the new token written; int8 caches take (B, S, HKV) scales,
    dequantized in f32 (JAX's jnp path rounds them to q's dtype first)."""
    return ops.decode_attention(q, k_cache, v_cache, slot_pos, pos,
                                window=window, n_sink=n_sink, scale=scale,
                                k_scale=k_scale, v_scale=v_scale)


def cache_write(k_cache: torch.Tensor, v_cache: torch.Tensor,
                slot_pos: torch.Tensor, k_new: torch.Tensor,
                v_new: torch.Tensor, pos: int,
                k_scale: torch.Tensor | None = None,
                v_scale: torch.Tensor | None = None):
    """Write one token's k/v (B, 1, HKV, D) at ring slot ``pos % S`` of one
    layer's (B, S, HKV, D) cache, in place.

    Returns (k_cache, v_cache, slot_pos[, k_scale, v_scale]) as JAX does:
    the cache tensors themselves, and a new ``slot_pos`` with ``pos`` at the
    slot (the one passed in is left as it was); scales only for int8
    caches, else None."""
    slot = pos % k_cache.shape[1]
    new_slot_pos = slot_pos.clone()
    new_slot_pos[slot] = pos
    if k_cache.dtype == torch.int8:
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        for dst, src in ((k_cache, kq), (v_cache, vq), (k_scale, ks),
                         (v_scale, vs)):
            dst.narrow(1, slot, 1).copy_(src)
        return k_cache, v_cache, new_slot_pos, k_scale, v_scale
    k_cache.narrow(1, slot, 1).copy_(k_new)
    v_cache.narrow(1, slot, 1).copy_(v_new)
    return k_cache, v_cache, new_slot_pos, None, None
