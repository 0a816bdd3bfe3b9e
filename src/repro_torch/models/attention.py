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

On a mesh (DTensor operands) the kernels take local tensors, so each entry
point runs them under ``local_map``. Prefill: batch over the data axes
(where it divides), query heads over ``model`` where their count divides,
each rank slicing the KV heads its query heads read from a replicated
KV where the KV heads do not divide (hymba's 25 heads replicate). Decode:
the caches shard their sequence over ``model`` (context-parallel decode,
``launch/sharding.py``); each rank attends over its own slots, through
the decode kernel on the card, which also writes each row's log-sum-exp,
and the partial results merge by it over ``model`` (``merge_lse``).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core.types import resolve_device
from repro_torch.kernels import ops

DATA_AXES = ("pod", "data")


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        n_sink: int = 0, scale: float | None = None
                        ) -> torch.Tensor:
    """q (B, Lq, H, D), RoPE applied; k/v (B, Lk, HKV, D); query offset
    ``Lk - Lq`` (ends aligned); with a window, keys ``j < n_sink`` stay
    visible (attention sinks). The (Lq, Lk) scores never reach device
    memory on CUDA. Differentiable: with operands that require grad it
    runs ``ops.FlashAttention`` (on CUDA the forward kernel, which also
    writes each row's log-sum-exp, and the backward kernel), where JAX
    differentiates this jnp function with XLA. DTensor operands run
    under ``local_map`` (module docstring)."""
    if isinstance(q, DTensor):
        return _flash_on_mesh(q, k, v, causal=causal, window=window,
                              n_sink=n_sink, scale=scale)
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               n_sink=n_sink, scale=scale)


def _dims_named(mesh, pick) -> list[int]:
    return [i for i, n in enumerate(mesh.mesh_dim_names) if pick(n)]


def head_split(h: int, hkv: int, n_model: int) -> str:
    """How prefill attention splits heads over ``n_model`` ranks:
    ``"shard"`` (query and KV heads both divide), ``"slice"`` (query heads
    divide and each rank's query heads read a contiguous block of KV
    heads, sliced from a replicated KV) or ``"replicate"`` (every rank
    computes every head of its batch shard)."""
    g = h // hkv
    if h % n_model == 0 and hkv % n_model == 0:
        return "shard"
    if h % n_model == 0:
        h_loc = h // n_model
        if h_loc % g == 0 or g % h_loc == 0:
            return "slice"
    return "replicate"


def _flash_on_mesh(q, k, v, *, causal, window, n_sink, scale):
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    b, h, hkv = q.shape[0], q.shape[2], k.shape[2]
    data = _dims_named(mesh, lambda n: n in DATA_AXES)
    model = _dims_named(mesh, lambda n: n == "model")
    n_data = math.prod(mesh.size(i) for i in data)
    n_model = math.prod(mesh.size(i) for i in model)
    split = head_split(h, hkv, n_model)
    batch_p = Shard(0) if b % n_data == 0 and b >= n_data else Replicate()

    def place(model_p):
        return tuple(batch_p if i in data else model_p if i in model
                     else Replicate() for i in range(mesh.ndim))

    q_p = place(Replicate() if split == "replicate" else Shard(2))
    kv_p = place(Shard(2) if split == "shard" else Replicate())
    kv_grad = place(Partial()) if split == "slice" else kv_p
    g = h // hkv

    def fn(ql, kl, vl):
        if split == "slice":
            r = mesh.get_coordinate()[model[0]]
            h_loc = h // n_model
            lo, hi = (r * h_loc) // g, ((r + 1) * h_loc - 1) // g + 1
            kl = kl[:, :, lo:hi].contiguous()
            vl = vl[:, :, lo:hi].contiguous()
        return ops.flash_attention(ql, kl, vl, causal=causal, window=window,
                                   n_sink=n_sink, scale=scale)

    return local_map(fn, out_placements=list(q_p),
                     in_placements=(q_p, kv_p, kv_p),
                     in_grad_placements=(q_p, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


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
    dequantized in f32 (JAX's jnp path rounds them to q's dtype first).
    DTensor caches run under ``local_map``, context-parallel where their
    sequence is split (module docstring)."""
    if isinstance(k_cache, DTensor):
        return _decode_on_mesh(q, k_cache, v_cache, slot_pos, pos,
                               window=window, n_sink=n_sink, scale=scale,
                               k_scale=k_scale, v_scale=v_scale)
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
    caches, else None. DTensor caches are written under ``local_map``: the
    rank whose slots hold ``slot`` writes it."""
    slot = pos % k_cache.shape[1]
    new_slot_pos = slot_pos.clone()
    new_slot_pos[slot] = pos
    if isinstance(k_cache, DTensor):
        _write_on_mesh(k_cache, v_cache, slot, k_new, v_new, k_scale, v_scale)
    else:
        _write_slot(k_cache, v_cache, slot, k_new, v_new, k_scale, v_scale)
    if k_cache.dtype == torch.int8:
        return k_cache, v_cache, new_slot_pos, k_scale, v_scale
    return k_cache, v_cache, new_slot_pos, None, None


def _write_slot(k_cache, v_cache, slot, k_new, v_new, k_scale, v_scale):
    if k_cache.dtype == torch.int8:
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        for dst, src in ((k_cache, kq), (v_cache, vq), (k_scale, ks),
                         (v_scale, vs)):
            dst.narrow(1, slot, 1).copy_(src)
        return
    k_cache.narrow(1, slot, 1).copy_(k_new)
    v_cache.narrow(1, slot, 1).copy_(v_new)


def _cache_placements(cache):
    """A query's or new token's placements beside a cache's: the cache's,
    with its sequence split (dim 1) replicated."""
    return tuple(Replicate() if p == Shard(1) else p
                 for p in cache.placements)


def _seq_split(cache) -> tuple[list[int], int]:
    """The mesh dims over which a (B, S, HKV, D) cache splits S (with more
    than one rank), and this rank's first slot."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = cache.device_mesh
    dims = [i for i, p in enumerate(cache.placements)
            if p == Shard(1) and mesh.size(i) > 1]
    _, offset = compute_local_shape_and_global_offset(
        cache.shape, mesh, cache.placements)
    return dims, offset[1]


def merge_lse(o: torch.Tensor, lse: torch.Tensor, reduce) -> torch.Tensor:
    """Decode attention over a cache cut into slot ranges, from each
    range's part: ``o`` (..., B, 1, H, D) and ``lse`` (..., B, H), as
    ``ops.decode_attention(..., return_lse=True)`` gives them. ``reduce(x,
    op)`` combines ``x`` over the parts, ``op`` "max" or "sum": an
    all-reduce over the mesh dims a sequence is split across, or a
    reduction over the leading axis of parts stacked on one card. A part
    that sees no slot (lse -inf) weighs 0; a row that sees none anywhere is
    0, as the whole call gives it. Returns (B, 1, H, D) in o's dtype."""
    m = reduce(lse, "max")
    w = torch.where(torch.isfinite(lse), torch.exp(lse - m), 0.0)
    num = reduce(o.to(torch.float32) * w[..., None, :, None], "sum")
    den = reduce(w, "sum")
    return (num / den[..., None, :, None].clamp_min(1e-30)).to(o.dtype)


def _decode_on_mesh(q, k_cache, v_cache, slot_pos, pos, *, window, n_sink,
                    scale, k_scale, v_scale):
    from torch.distributed.tensor.experimental import local_map
    mesh = k_cache.device_mesh
    split, lo = _seq_split(k_cache)
    kv_p = k_cache.placements
    q_p = _cache_placements(k_cache)
    quant = k_scale is not None
    sc_p = k_scale.placements if quant else None
    kw = dict(window=window, n_sink=n_sink, scale=scale)

    def fn(ql, kl, vl, ksl, vsl):
        sp = slot_pos[lo:lo + kl.shape[1]]
        if not split:
            return ops.decode_attention(ql, kl, vl, sp, pos, k_scale=ksl,
                                        v_scale=vsl, **kw)
        o, lse = ops.decode_attention(ql, kl, vl, sp, pos, k_scale=ksl,
                                      v_scale=vsl, return_lse=True, **kw)

        def over_split(x, op):
            for i in split:
                x = funcol.all_reduce(x, op, (mesh, i))
            return x
        return merge_lse(o, lse, over_split)

    return local_map(fn, out_placements=list(q_p),
                     in_placements=(q_p, kv_p, kv_p, sc_p, sc_p),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k_cache, v_cache, k_scale, v_scale)


def _write_on_mesh(k_cache, v_cache, slot, k_new, v_new, k_scale, v_scale):
    from torch.distributed.tensor.experimental import local_map
    _, lo = _seq_split(k_cache)
    new_p = _cache_placements(k_cache)
    quant = k_cache.dtype == torch.int8
    sc_p = k_scale.placements if quant else None

    def fn(kl, vl, knl, vnl, ksl, vsl):
        if 0 <= slot - lo < kl.shape[1]:
            _write_slot(kl, vl, slot - lo, knl, vnl, ksl, vsl)

    local_map(fn, out_placements=None,
              in_placements=(k_cache.placements, k_cache.placements, new_p,
                             new_p, sc_p, sc_p),
              device_mesh=k_cache.device_mesh, redistribute_inputs=True)(
        k_cache, v_cache, k_new, v_new, k_scale, v_scale)
