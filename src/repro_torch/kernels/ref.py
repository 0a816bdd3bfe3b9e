"""Plain PyTorch versions of the port's kernels (PyTorch port of
``repro.kernels.ref``): the cosine top-k in its three mask forms, each
also over an int8 slab with per-row scales, the IVF
candidate top-k, and the two attention kernels of the model-backed miss
path (prefill flash attention and single-token decode attention), and
the counter-based draws of the reference's ``jax.random`` streams
(threefry2x32, ``threefry_fill_ref``).

They define the numerical contract. The kernel wrappers take them for CPU
tensors, and ``chip_smoke.py`` holds each CUDA kernel against them on the
card.
"""
from __future__ import annotations

import numpy as np
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


def quant_cosine_topk_ref(queries: torch.Tensor, keys_q: torch.Tensor,
                          scales: torch.Tensor, valid: torch.Tensor, k: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the per-row-scale kernels: int8 ``keys_q`` (N, d)
    times their (N,) f32 ``scales`` (a product, as the Pallas kernel
    dequantizes), then ``cosine_topk_ref``; ``valid`` is (N,) or (B, N)."""
    keys = keys_q.to(torch.float32) * scales[:, None]
    return cosine_topk_ref(queries, keys, valid, k)


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


def quant_cosine_topk_interval_ref(queries: torch.Tensor, keys_q: torch.Tensor,
                                   scales: torch.Tensor, valid: torch.Tensor,
                                   starts: torch.Tensor, sizes: torch.Tensor,
                                   k: int
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``cosine_topk_interval_ref`` over a per-row-scale int8 slab."""
    keys = keys_q.to(torch.float32) * scales[:, None]
    return cosine_topk_interval_ref(queries, keys, valid, starts, sizes, k)


TILE = 128                         # keys per tile of the dense form's pass 1
EMPTY_KEY = torch.iinfo(torch.int64).max   # sort key of a row that sees nothing


def visible_tiles_ref(mask: torch.Tensor) -> torch.Tensor:
    """(B, N) bool -> (B, T) bool, T = ceil(N / 128): whether row b sees a
    slot of 128-key tile t (N padded with False). The plain version of the
    dense form's pass 0 bitmap."""
    b, n = mask.shape
    t = -(-n // TILE)
    padded = torch.zeros((b, t * TILE), dtype=torch.bool, device=mask.device)
    padded[:, :n] = mask
    return padded.view(b, t, TILE).any(-1)


def tile_summary_ref(mask: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the dense form's pass 0
    (``csrc/cosine_topk.cu::cosine_topk_tile_summary``): (B, N) bool mask ->
      tile_bits (B, W) int32, W = ceil(T / 32): bit t % 32 of word t // 32
        set where row b sees a slot of tile t (``visible_tiles_ref``);
      sort_key (B,) int64: (first tile << 39) | (last tile << 15) |
        min(tiles, 2**15 - 1); ``EMPTY_KEY`` for a row that sees nothing;
      tiles (B,) int32: the number of tiles the row sees."""
    flags = visible_tiles_ref(mask)
    b, t = flags.shape
    w = -(-t // 32)
    padded = torch.zeros((b, w * 32), dtype=torch.int64, device=mask.device)
    padded[:, :t] = flags
    shifts = torch.arange(32, device=mask.device)
    words = (padded.view(b, w, 32) << shifts).sum(-1)          # [0, 2**32)
    count = flags.sum(-1)
    first = flags.to(torch.uint8).argmax(-1)
    last = t - 1 - flags.flip(-1).to(torch.uint8).argmax(-1)
    key = (first << 39) | (last << 15) | count.clamp(max=(1 << 15) - 1)
    key = torch.where(count > 0, key, EMPTY_KEY)
    bits = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return bits.to(torch.int32), key, count.to(torch.int32)


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


def _softmax_visible(s: torch.Tensor, visible: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis of f32 scores ``s`` where ``visible``,
    with the kernels' conventions: an invisible entry weighs exactly 0,
    and a row with nothing visible gets all-zero weights (the kernels'
    ``l = max(l, 1e-30)``), hence a zero output."""
    s = s.masked_fill(~visible, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    return p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        n_sink: int = 0, scale: float | None = None
                        ) -> torch.Tensor:
    """Plain version of the prefill flash-attention kernel.

    Args:
      q: (B, Lq, H, D) float32 or bfloat16, RoPE applied.
      k, v: (B, Lk, HKV, D), the layout of the Pallas kernel
        (``flash_attention_pallas``): query head h reads KV head
        ``h // (H // HKV)``. (``repro.kernels.ref.flash_attention_ref``
        takes K/V already expanded to H heads.)
      causal: key position j is visible to query row i when ``j <= i +
        Lk - Lq`` (the ends of the two sequences are aligned).
      window: also ``j > i + Lk - Lq - window``; ``None`` is no window.
      n_sink: with a window, keys ``j < n_sink`` stay visible.
      scale: default ``1 / sqrt(D)``.
    Returns:
      (B, Lq, H, D) in q's dtype. Products and sums in f32; a row with
      nothing visible is 0.
    """
    s, _, _ = _flash_scores(q, k, scale)
    visible = _flash_visible(q.shape[1], k.shape[1], causal, window, n_sink,
                             q.device)
    vf = v.to(torch.float32).repeat_interleave(q.shape[2] // v.shape[2],
                                               dim=2)
    p = _softmax_visible(s, visible)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def _flash_visible(lq: int, lk: int, causal: bool, window: int | None,
                   n_sink: int, device) -> torch.Tensor:
    """(Lq, Lk) visibility of the prefill kernels (query row i at position
    ``i + Lk - Lq``)."""
    qpos = torch.arange(lq, device=device)[:, None] + (lk - lq)
    kpos = torch.arange(lk, device=device)[None, :]
    visible = torch.ones((lq, lk), dtype=torch.bool, device=device)
    if causal:
        visible &= kpos <= qpos
    if window is not None:
        wmask = kpos > qpos - window
        if n_sink > 0:
            wmask |= kpos < n_sink
        visible &= wmask
    return visible


def _flash_scores(q: torch.Tensor, k: torch.Tensor, scale: float | None):
    """f32 scores (B, H, Lq, Lk), K expanded to H heads, and the scale."""
    g = q.shape[2] // k.shape[2]
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    kf = k.to(torch.float32).repeat_interleave(g, dim=2)
    return torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), kf) * scale, \
        kf, scale


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int | None = None, n_sink: int = 0,
                            scale: float | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel's training form: the output of
    ``flash_attention_ref`` and each row's log-sum-exp of its visible
    scaled scores, (B, H, Lq) f32, -inf for a row that sees nothing."""
    out = flash_attention_ref(q, k, v, causal=causal, window=window,
                              n_sink=n_sink, scale=scale)
    s, _, _ = _flash_scores(q, k, scale)
    visible = _flash_visible(q.shape[1], k.shape[1], causal, window, n_sink,
                             q.device)
    lse = torch.logsumexp(s.masked_fill(~visible, float("-inf")), dim=-1)
    return out, lse


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            dout: torch.Tensor, lse: torch.Tensor, *,
                            causal: bool = True, window: int | None = None,
                            n_sink: int = 0, scale: float | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain version of the backward kernel (row 9b): dQ, dK, dV of the
    prefill attention from its operands, its output ``out``, the output's
    gradient ``dout`` and the forward's row log-sum-exp ``lse`` (B, H, Lq),
    by the explicit formulas in f32:

        P = exp(S - lse) on visible entries, 0 elsewhere (S scaled)
        dV = P^T dO;  dP = dO V^T;  Di = rowsum(dO * O)
        dS = P * (dP - Di);  dQ = scale dS K;  dK = scale dS^T Q

    dK and dV sum over the query heads of each KV head's group. A row
    that sees no key has P = 0 and adds nothing. Returns the three
    gradients in the operands' dtype."""
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    s, kf, scale = _flash_scores(q, k, scale)
    visible = _flash_visible(lq, lk, causal, window, n_sink, q.device)
    p = torch.where(visible, torch.exp(s - lse[..., None]), 0.0)
    vf = v.to(torch.float32).repeat_interleave(g, dim=2)
    dof = dout.to(torch.float32)
    di = torch.einsum("bqhd,bqhd->bhq", dof, out.to(torch.float32))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - di[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(torch.float32)) * scale
    dk = dk.reshape(b, lk, hkv, g, d).sum(dim=3)
    dv = dv.reshape(b, lk, hkv, g, d).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, slot_pos: torch.Tensor,
                         pos: int, *, window: int | None = None,
                         n_sink: int = 0, scale: float | None = None,
                         k_scale: torch.Tensor | None = None,
                         v_scale: torch.Tensor | None = None,
                         return_lse: bool = False) -> torch.Tensor:
    """Plain version of the decode-attention kernel: one query token per
    sequence over every visible slot of a (ring) KV cache.

    Args:
      q: (B, 1, H, D) float32 or bfloat16, RoPE applied at ``pos``.
      k_cache, v_cache: (B, S, HKV, D) float32, bfloat16 or int8 (one
        layer); int8 entries are multiplied by ``k_scale``/``v_scale``
        (B, S, HKV) f32 in f32, as the Pallas kernel dequantizes after load.
      slot_pos: (S,) int32 absolute position held by each slot, -1 empty.
      pos: the current position. Slot s is visible when ``0 <= slot_pos[s]
        <= pos`` and, with a window, ``slot_pos[s] > pos - window`` or
        ``slot_pos[s] < n_sink``.
    Returns:
      (B, 1, H, D) in q's dtype; a row with no visible slot is 0. With
      ``return_lse`` (merging attention over a cache split in parts, as
      the model's context-parallel decode does): (o (B, 1, H, D) f32, lse
      (B, H) f32, -inf where no slot is visible).
    """
    b, _, h, d = q.shape
    hkv = k_cache.shape[2]
    g = h // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    kf, vf = k_cache.to(torch.float32), v_cache.to(torch.float32)
    if k_cache.dtype == torch.int8:
        kf = kf * k_scale[..., None]
        vf = vf * v_scale[..., None]
    qg = q.to(torch.float32).reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bshd->bhgs", qg, kf) * scale
    visible = (slot_pos >= 0) & (slot_pos <= pos)
    if window is not None:
        wmask = slot_pos > pos - window
        if n_sink > 0:
            wmask |= slot_pos < n_sink
        visible &= wmask
    p = _softmax_visible(s, visible)
    o = torch.einsum("bhgs,bshd->bhgd", p, vf).reshape(b, 1, h, d)
    if return_lse:
        lse = torch.logsumexp(s.masked_fill(~visible, float("-inf")), dim=-1)
        return o, lse.reshape(b, h)
    return o.to(q.dtype)


# --------------------------------------------------------------------- #
# threefry2x32: the reference's jax.random streams (csrc/threefry.cu)
# --------------------------------------------------------------------- #
M32 = 0xFFFFFFFF
THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
THREEFRY_KINDS = {"bits": 0, "uniform": 1, "normal": 2}
#: how a draw's elements map to hashed counters (``jax_threefry_
#: partitionable`` on or off; ``threefry_fill_ref``)
THREEFRY_LAYOUTS = ("partitionable", "original")
#: elements a block of the original layout: jax draws more words than
#: this as blocks of this many, each under a key split from the draw's
THREEFRY_BLOCK = M32
#: elements a chunk of the plain draw. On the CPU a chunk is under
#: PyTorch's grain size (32,768), so every op of it runs on one thread:
#: ~300 small ops a chunk would otherwise each wait on a parallel region,
#: which under oversubscribed cores (test workers) costs milliseconds an op;
#: its int64 words stay in cache. On a card fewer, larger chunks cut the
#: launches (~200 MB of temporaries).
THREEFRY_CHUNK = 1 << 14
THREEFRY_CHUNK_DEVICE = 1 << 22
#: Giles' single-precision erfinv (XLA's ``ErfInv32``), highest degree
#: first: w < 5 and w >= 5, with w = -log1p(-u * u)
ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                -4.39150654e-06, 0.00021858087, -0.00125372503,
                -0.00417768164, 0.246640727, 1.50140941)
ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)
#: f32 constants of ``jax.random.normal``: its uniform's lower end
#: nextafter(-1, 0) and sqrt(2), each rounded to f32
NORMAL_LO = -0.99999994039535522
SQRT2_F32 = 1.41421353816986084


def threefry2x32_ref(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter words (x0, x1) under
    the key (k0, k1), as ``jax._src.prng`` computes it. x0 and x1 are
    int64 tensors holding uint32 values (left as they are); so are the two
    words returned. The rounds update two new tensors in place."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = x0.add(k0).bitwise_and_(M32)
    x1 = x1.add(k1).bitwise_and_(M32)
    high = torch.empty_like(x1)
    for i in range(5):
        for r in THREEFRY_ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(M32)
            torch.bitwise_left_shift(x1, r, out=high)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(high) \
                .bitwise_and_(M32).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(M32)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(M32)
    return x0, x1


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a * b + c with one rounding, as XLA's CPU code contracts it:
    emulated in f64, where a product of two f32 is exact. The f64 sum
    rounds once more than an FMA, which differs only when it falls on an
    f32 tie."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _cpu_numpy(fn, torch_fn, x: torch.Tensor) -> torch.Tensor:
    """``torch_fn(x)``, on the CPU through numpy's ``fn``: PyTorch's CPU
    kernels for log1p and sqrt split even a few thousand elements over the
    intra-op threads, which on oversubscribed cores (parallel test workers)
    costs milliseconds a call; numpy runs on the caller's thread."""
    if x.device.type == "cpu":
        return torch.from_numpy(fn(x.numpy()))
    return torch_fn(x)


def erfinv_ref(x: torch.Tensor) -> torch.Tensor:
    """erfinv of f32 ``x`` in (-1, 1) as XLA computes it on the CPU:
    Giles' polynomial in w = -log1p(-x * x), evaluated by Horner's rule
    with a fused multiply-add a step (``_fma``), +-inf at +-1."""
    w = -_cpu_numpy(np.log1p, torch.log1p, -x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5,
                    _cpu_numpy(np.sqrt, torch.sqrt, w.clamp_min(0.0)) - 3.0)
    coef = [torch.where(small, a, b)
            for a, b in zip(*(torch.tensor(c, dtype=torch.float32,
                                           device=x.device)
                              for c in (ERFINV_SMALL, ERFINV_LARGE)))]
    p = coef[0]
    for c in coef[1:]:
        p = _fma(p, w, c)
    r = p * x
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max, r)


def threefry_split_original(key, num: int) -> list[tuple[int, int]]:
    """``jax._src.prng._threefry_split_original(key, (num,))`` (jax 0.9.0,
    ``jax/_src/prng.py:1150``): ``threefry_2x32`` of the counters 0 ..
    2 num - 1, which hashes the pairs (i, num + i) for i < num to (y0,
    y1); key j is words 2j and 2j + 1 of [y0; y1]."""
    i = torch.arange(num, dtype=torch.int64)
    y0, y1 = threefry2x32_ref(int(key[0]) & M32, int(key[1]) & M32, i,
                              i + num)
    y = torch.cat([y0, y1]).tolist()
    return [(y[2 * j], y[2 * j + 1]) for j in range(num)]


def threefry_blocks(key, total: int | None, offset: int, count: int
                    ) -> list[tuple[tuple[int, int], int, int, int, int]]:
    """The original layout's pieces of elements ``offset`` .. ``offset +
    count - 1`` of a draw of ``total`` (default ``offset + count``), as
    ``_threefry_random_bits_original`` (``jax/_src/prng.py:1203-1222``)
    blocks it: ``nblocks, rem = divmod(total, 2^32 - 1)``; with no full
    block the draw's key draws all, else the key splits (original mode)
    into nblocks + 1 keys, block b of 2^32 - 1 elements under key b and
    the last ``rem`` under the last. Each piece is (block key, block size,
    first element in the block, elements, first element in the
    window)."""
    total = offset + count if total is None else total
    nblocks, rem = divmod(total, THREEFRY_BLOCK)
    keys = threefry_split_original(key, nblocks + 1) if nblocks \
        else [tuple(int(k) & M32 for k in key)]
    pieces = []
    for b, k in enumerate(keys):
        base = b * THREEFRY_BLOCK
        size = THREEFRY_BLOCK if b < nblocks else rem
        first, end = max(offset, base), min(offset + count, base + size)
        if first < end:
            pieces.append((k, size, first - base, end - first,
                           first - offset))
    return pieces


def threefry_seams(total: int) -> list[int]:
    """Where the original layout's pairing turns in a draw of ``total``:
    each block's first element and its h (the first element of its
    pairs' second words), and the end (the odd block's pad), sorted."""
    nblocks, rem = divmod(total, THREEFRY_BLOCK)
    sizes = [THREEFRY_BLOCK] * nblocks + ([rem] if rem else [])
    seams = {total}
    for b, size in enumerate(sizes):
        seams |= {b * THREEFRY_BLOCK, b * THREEFRY_BLOCK + -(-size // 2)}
    return sorted(seams)


def threefry_fill_ref(out: torch.Tensor, key, *, kind: str = "normal",
                      offset: int = 0, lo: float = NORMAL_LO,
                      hi: float = 1.0, scale: float = 1.0,
                      layout: str = "partitionable",
                      total: int | None = None) -> torch.Tensor:
    """Fill the contiguous ``out`` with elements ``offset`` .. ``offset +
    out.numel() - 1`` of a draw of ``key`` (two uint32), in row-major
    order. Element i hashes a pair of counter words to (b0, b1), by
    ``layout``:
      ``partitionable`` (``jax_threefry_partitionable`` on): the words
        (c >> 32, c & 0xFFFFFFFF) of c = i, as ``jax._src.prng.
        iota_2x32_shape`` splits a flat index; its 32 bits are b0 ^ b1;
      ``original`` (the flag off; ``jax._src.prng.threefry_2x32``,
        ``jax/_src/prng.py:1092-1135``): in a draw of n (``total``, or a
        block of it, ``threefry_blocks``) the pairs (j, j + h), h =
        ceil(n / 2), where j + h < n, else (j, 0), the odd size's pad;
        element i < h is b0 of pair i, element i >= h b1 of pair i - h.
        ``total`` defaults to ``offset + out.numel()``.

    ``kind``:
      ``bits``: the 32 bits (``jax.random.bits``), into int64;
      ``uniform``: max(lo, f * (hi - lo) + lo), one fused multiply-add,
        with f the float of the bits' top 23 as mantissa of [1, 2), minus
        1 (``jax.random.uniform`` of minval lo, maxval hi), into float32;
      ``normal``: scale * (sqrt(2) * erfinv(u)) with u that uniform at lo =
        nextafter(-1, 0), hi = 1 (``jax.random.normal`` times ``scale``,
        each product in f32), cast to ``out``'s float32 or bfloat16
        (round to nearest even).
    The work goes in chunks of ``THREEFRY_CHUNK`` elements on the CPU
    (``THREEFRY_CHUNK_DEVICE`` elsewhere), so no int64 temporary is larger
    than one chunk. Returns ``out``."""
    flat = out.view(-1)
    if layout == "partitionable":
        pieces = [(key, None, offset, flat.numel(), 0)]
    else:
        pieces = threefry_blocks(key, total, offset, flat.numel())
    chunk = THREEFRY_CHUNK if out.device.type == "cpu" \
        else THREEFRY_CHUNK_DEVICE
    for k, size, first, count, at in pieces:
        k0, k1 = (int(w) & M32 for w in k)
        for start in range(0, count, chunk):
            n = min(chunk, count - start)
            c = torch.arange(first + start, first + start + n,
                             dtype=torch.int64, device=out.device)
            if size is None:
                b0, b1 = threefry2x32_ref(k0, k1, c >> 32, c & M32)
                bits = b0 ^ b1
            else:
                half = (size + 1) // 2
                upper = c >= half
                x0 = torch.where(upper, c - half, c)
                x1 = x0 + half
                b0, b1 = threefry2x32_ref(
                    k0, k1, x0, torch.where(x1 < size, x1, 0))
                bits = torch.where(upper, b1, b0)
            flat[at + start:at + start + n] = _draw_of_bits(
                bits, kind, lo, hi, scale, out.dtype)
    return out


def _draw_of_bits(bits: torch.Tensor, kind: str, lo: float, hi: float,
                  scale: float, dtype: torch.dtype) -> torch.Tensor:
    """The draws of ``threefry_fill_ref``'s ``kind`` from their 32 bits."""
    if kind == "bits":
        return bits
    f32, dev = torch.float32, bits.device
    lo32 = torch.tensor(lo, dtype=f32, device=dev)
    span = torch.tensor(hi, dtype=f32, device=dev) - lo32
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(f32) - 1.0
    u = torch.maximum(lo32, _fma(f, span, lo32))
    if kind == "uniform":
        return u
    sqrt2 = torch.tensor(SQRT2_F32, dtype=f32, device=dev)
    x = sqrt2 * erfinv_ref(u) * torch.tensor(scale, dtype=f32, device=dev)
    return x.to(dtype)
