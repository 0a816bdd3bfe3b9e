"""Launch wrappers of the hand-written CUDA cosine top-k
(``csrc/cosine_topk.cu``), the Hopper replacement of the six TPU kernels of
``repro/kernels/cosine_topk.py``:

  ``cosine_topk_cuda``           <- ``cosine_topk_pallas``: shared (N,) mask
  ``cosine_topk_interval_cuda``  <- ``cosine_topk_interval_pallas``: shared
                                    mask and one slot interval per row (the
                                    tenancy path)
  ``cosine_topk_masked_cuda``    <- ``cosine_topk_masked_pallas``: dense
                                    (B, N) mask
  ``quant_cosine_topk_cuda``, ``quant_cosine_topk_interval_cuda``,
  ``quant_cosine_topk_masked_cuda`` <- the ``quant_*_pallas`` three: the same
                                    over an int8 slab with a per-row (N,) f32
                                    scale (``quantize_keys``)

Contract (that of ``repro_torch.kernels.ref``): queries (B, d) float32,
L2-normalized; keys (N, d) float32, bfloat16 or int8 (int8 scaled by 1/127
in the kernel); k <= 32 (``MAX_K``: a top-k list keeps one entry per lane
of a warp, so the IVF probe's k=16 runs the same code as the main path's
k=4). Returns (scores (B, k) f32 sorted descending, slot ids (B, k)
int32), ties to the lowest visible slot id, (-inf, -1) where fewer than k
slots are visible.

Each wrapper checks its arguments, allocates the outputs and, when pass 1
runs over more than one chunk, its scratch with ``torch.empty``, launches on
the current stream without synchronizing (pass 2 only to merge chunks),
raises if a launch was refused, and counts its launches in
``launches[name]``. The interval wrappers sort the rows by interval on the
card (``interval_order``: the kernel reads rows through the permutation,
so a query tile holds rows of about one interval, and writes each row's
top-k to its own place) and read back, in one host sync per call, the
check ``starts + sizes <= N`` with the count of distinct intervals and the
largest size, from which ``split`` picks the tile height and the chunks.
The dense-mask wrappers do the same from a summary of the mask
(``masked_plan``): pass 0 (``tile_summary``) writes, per row, the bitmap of
the 128-key tiles in which the row sees a slot and a sort key, and a
second kernel ranks the rows by key (a stable sort on the card) so that
rows that see alike are side by side; the read-back
gives the count of distinct keys and the most tiles a row sees. Pass 1
then scores only the tiles that some row of its query tile sees.
The wrappers take CUDA tensors only: ``ops`` sends CPU tensors to the plain
versions. ``tile_summary`` (and so ``masked_plan``) runs its plain version on
CPU tensors, so the plan is tested on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: kernel launches in this process, by kernel; a run sets them to 0
#: (``reset_launches``) and reads them back to show which path went through
#: which kernel
launches = {"cosine_topk": 0, "cosine_topk_interval": 0,
            "cosine_topk_masked": 0, "quant_cosine_topk": 0,
            "quant_cosine_topk_interval": 0, "quant_cosine_topk_masked": 0}

MAX_K = 32      # one list entry per lane (MAX_K in csrc/warp_topk.cuh)
BLOCK_Q = 64    # query rows per wide block of pass 1 (BQ_WIDE in the source)
BLOCK_Q_NARROW = 4   # one warp per query row (BQ_NARROW in the source)
BLOCK_Q_INTERVAL = (64, 32, 16)   # wide tile heights of the grouped forms
# the shared-mask forms' tensor-core tiles (tc::BQ in the source): a block
# takes the serve path's whole batch of 128 queries, so each key is read once
BLOCK_Q_TC = 128
BLOCK_N = 128   # keys per tile of pass 1 (BN and tc::BN in the source)
BLOCKS_PER_SM = 4
TC_BLOCKS_PER_SM = 1   # the tensor-core block holds ~210 KB of shared memory
# tensor-core tiles where at least TC_MIN_ROWS query rows fill them and there
# are at least TC_MIN_SCORES scores: a block of one 128 x 128 tile takes
# ~40 us however few blocks there are, while the 4-row tiles' time grows with
# B x N and passes it near 2**18 scores on an H100 (B=128 from N=2,048, B=64
# from 4,096, B=32 from 8,192; cosine_variants.py, PERF.md §6)
TC_MIN_ROWS = 32
TC_MIN_SCORES = 1 << 18
# the dense form's blocks list their 128-key tiles in shared memory, at most
# this many (DENSE_LIST in the source): its chunks cover N in such lists
DENSE_LIST = 1024
# the grouped (interval and dense) forms' blocks an SM by tile height, the
# best of 1, 2 and 4 for both forms in a sweep on an H100 (f32 and int8
# keys; masked_variants.py, PERF.md §6): two for 64- and 32-row tiles
# (126-128 registers a thread, so two fit an SM; one left the FMA loop
# waiting on its loads), four for 16-row ones
GROUPED_BLOCKS_PER_SM = {64: 2, 32: 2, 16: 4, BLOCK_Q_NARROW: BLOCKS_PER_SM}
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check_common(queries: torch.Tensor, keys: torch.Tensor, k: int) -> None:
    if queries.dim() != 2 or keys.dim() != 2:
        raise ValueError(f"queries and keys must be 2-D, got "
                         f"{tuple(queries.shape)} and {tuple(keys.shape)}")
    if queries.dtype != torch.float32:
        raise ValueError(f"queries must be float32, got {queries.dtype}")
    if keys.dtype not in DTYPE_CODE:
        raise ValueError(f"keys must be float32, bfloat16 or int8, got "
                         f"{keys.dtype}")
    b, d = queries.shape
    n = keys.shape[0]
    if b < 1 or n < 1 or d < 1:
        raise ValueError(f"empty operand: B={b} N={n} d={d}")
    if keys.shape[1] != d:
        raise ValueError(f"shape mismatch: queries {tuple(queries.shape)}, "
                         f"keys {tuple(keys.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be within [1, {MAX_K}], got {k}")


def _check_mask(name: str, mask: torch.Tensor, shape: tuple) -> None:
    if mask.dtype != torch.bool:
        raise ValueError(f"{name} must be bool, got {mask.dtype}")
    if tuple(mask.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(mask.shape)}")


def _check_layout(*tensors: torch.Tensor) -> None:
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("every operand must be contiguous")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("every operand must be on one device")


def check_args(queries: torch.Tensor, keys: torch.Tensor, valid: torch.Tensor,
               k: int) -> None:
    """Raise ValueError on anything the shared-mask kernel does not take."""
    _check_common(queries, keys, k)
    if valid.dim() != 1:
        raise ValueError(f"valid must be a shared (N,) mask, got "
                         f"{tuple(valid.shape)}; a (B, N) mask goes to "
                         "cosine_topk_masked_cuda")
    _check_mask("valid", valid, (keys.shape[0],))
    _check_layout(queries, keys, valid)


def check_masked_args(queries: torch.Tensor, keys: torch.Tensor,
                      mask: torch.Tensor, k: int) -> None:
    """Raise ValueError on anything the dense-mask kernel does not take."""
    _check_common(queries, keys, k)
    _check_mask("mask", mask, (queries.shape[0], keys.shape[0]))
    _check_layout(queries, keys, mask)


def _check_interval_operands(queries: torch.Tensor, keys: torch.Tensor,
                             valid: torch.Tensor, starts: torch.Tensor,
                             sizes: torch.Tensor, k: int) -> None:
    check_args(queries, keys, valid, k)
    b = queries.shape[0]
    for name, t in (("starts", starts), ("sizes", sizes)):
        if t.dtype != torch.int32 or tuple(t.shape) != (b,):
            raise ValueError(f"{name} must be ({b},) int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    _check_layout(queries, starts, sizes)


def _outside(starts: torch.Tensor, sizes: torch.Tensor, n: int
             ) -> torch.Tensor:
    """Whether some interval leaves [0, n), on the operands' device;
    ``starts > n - sizes``, not ``starts + sizes > n``: no int32
    wrap-around."""
    return ((starts < 0) | (sizes < 0) | (starts > n - sizes)).any()


def _refuse_outside(n: int) -> None:
    raise ValueError(f"every interval must lie within [0, N={n}): need "
                     "0 <= starts, 0 <= sizes, starts + sizes <= N")


def check_interval_args(queries: torch.Tensor, keys: torch.Tensor,
                        valid: torch.Tensor, starts: torch.Tensor,
                        sizes: torch.Tensor, k: int) -> None:
    """Raise ValueError on anything the interval kernel does not take,
    including an interval that leaves the slab (``starts + sizes > N``)."""
    _check_interval_operands(queries, keys, valid, starts, sizes, k)
    if bool(_outside(starts, sizes, keys.shape[0])):
        _refuse_outside(keys.shape[0])


# sort key of an empty interval, and of a row that sees nothing
# (ref.EMPTY_KEY)
_EMPTY = torch.iinfo(torch.int64).max


def _sorted_intervals(starts: torch.Tensor, sizes: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    key = (starts.to(torch.int64) << 32) | sizes.to(torch.int64)
    key = torch.where(sizes > 0, key, _EMPTY)
    return torch.sort(key, stable=True)


def interval_order(starts: torch.Tensor, sizes: torch.Tensor
                   ) -> torch.Tensor:
    """(B,) int32 permutation of the query rows, sorted by interval (start,
    then size), the rows of an empty interval last; rows of equal intervals
    keep their order. One stable sort on the operands' device, no sync.
    ``starts`` and ``sizes`` are (B,) int32 within [0, 2**31)."""
    return _sorted_intervals(starts, sizes)[1].to(torch.int32)



def quantize_keys(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization, ``keys ~ q * scale``: (N, d)
    float32 -> (int8 (N, d), float32 (N,)). The semantics of the eager
    ``repro.kernels.cosine_topk.quantize_keys``: ``scale = max(absmax,
    1e-12) / 127`` divided, not multiplied by a reciprocal (XLA makes that
    rewrite under ``jit``, 1 ulp off on some rows); ``torch.round`` rounds
    half to even as ``jnp.round`` does. A zero row gets scale 1e-12/127.
    The divisor is a device tensor: CUDA computes ``x / 127.0`` with a Python
    scalar as ``x * (1/127)``."""
    if keys.dim() != 2 or keys.dtype != torch.float32:
        raise ValueError(f"keys must be (N, d) float32, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    absmax = keys.abs().amax(dim=1)
    scale = absmax.clamp_min(1e-12) / torch.full_like(absmax, 127.0)
    q = torch.round(keys / scale[:, None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def _check_scales(keys: torch.Tensor, scales: torch.Tensor) -> None:
    if keys.dtype != torch.int8:
        raise ValueError(f"keys with per-row scales must be int8, got "
                         f"{keys.dtype}")
    if scales.dtype != torch.float32 or tuple(scales.shape) != (
            keys.shape[0],):
        raise ValueError(f"scales must be ({keys.shape[0]},) float32, got "
                         f"{tuple(scales.shape)} {scales.dtype}")
    _check_layout(keys, scales)


def check_quant_args(queries: torch.Tensor, keys: torch.Tensor,
                     scales: torch.Tensor, valid: torch.Tensor, k: int
                     ) -> None:
    """``check_args`` for an int8 slab with per-row (N,) f32 scales."""
    check_args(queries, keys, valid, k)
    _check_scales(keys, scales)


def interval_plan(queries: torch.Tensor, keys: torch.Tensor,
                  valid: torch.Tensor, starts: torch.Tensor,
                  sizes: torch.Tensor, k: int,
                  scales: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, int, int]:
    """What the interval wrappers check and read back before a launch:
    ``check_interval_args`` (with ``scales``, for an int8 slab with per-row
    scales), then (``interval_order``, the number of distinct non-empty
    intervals, the largest size), one host sync in all."""
    if scales is not None:
        _check_scales(keys, scales)
    _check_interval_operands(queries, keys, valid, starts, sizes, k)
    n = keys.shape[0]
    key, order = _sorted_intervals(starts, sizes)
    new = torch.ones_like(key, dtype=torch.bool)
    new[1:] = key[1:] != key[:-1]
    groups = (new & (key != _EMPTY)).sum()
    outside, groups, biggest = torch.stack([
        _outside(starts, sizes, n).long(), groups,
        sizes.max().long()]).tolist()
    if outside:
        _refuse_outside(n)
    return order.to(torch.int32), groups, biggest


def check_quant_masked_args(queries: torch.Tensor, keys: torch.Tensor,
                            scales: torch.Tensor, mask: torch.Tensor, k: int
                            ) -> None:
    """``check_masked_args`` for an int8 slab with per-row scales."""
    check_masked_args(queries, keys, mask, k)
    _check_scales(keys, scales)


def tile_summary(mask: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Pass 0 of the dense form: a contiguous (B, N) bool mask -> (tile
    bitmaps (B, W) int32, sort keys (B,) int64, tiles seen (B,) int32), as
    ``ref.tile_summary_ref`` defines them, and the rows' order (B,) int32,
    a stable sort of the keys: rows with equal bitmaps side by side,
    ordered by their first and last visible tile, rows that see nothing
    last. A CUDA mask launches ``cosine_topk_tile_summary`` and
    ``cosine_topk_rank_rows`` (no sync); a CPU mask takes the plain
    versions."""
    if mask.device.type != "cuda":
        from repro_torch.kernels import ref   # ref imports this module
        bits, key, tiles = ref.tile_summary_ref(mask)
        order = torch.sort(key, stable=True).indices.to(torch.int32)
        return bits, key, tiles, order
    b, n = mask.shape
    words = -(-(-(-n // BLOCK_N)) // 32)
    bits = torch.empty((b, words), dtype=torch.int32, device=mask.device)
    key = torch.empty(b, dtype=torch.int64, device=mask.device)
    tiles = torch.empty(b, dtype=torch.int32, device=mask.device)
    order = torch.empty(b, dtype=torch.int32, device=mask.device)
    lib = _lib()
    with torch.cuda.device(mask.device):
        err = lib.cosine_topk_tile_summary_launch(
            mask.data_ptr(), b, n, bits.data_ptr(), key.data_ptr(),
            tiles.data_ptr(), order.data_ptr(),
            torch.cuda.current_stream(mask.device).cuda_stream)
    if err != 0:
        raise RuntimeError("cosine_topk_tile_summary launch failed: "
                           f"{lib.cosine_topk_error_string(err).decode()}")
    return bits, key, tiles, order


def masked_plan(queries: torch.Tensor, keys: torch.Tensor, mask: torch.Tensor,
                k: int, scales: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor, int, int]:
    """What the dense-mask wrappers check and read back before a launch:
    ``check_masked_args`` (with ``scales``, for an int8 slab with per-row
    scales), then (``tile_summary``'s order and bitmaps, the number of
    distinct keys of rows that see something, the most 128-key tiles a row
    sees), one host sync in all."""
    if scales is not None:
        _check_scales(keys, scales)
    check_masked_args(queries, keys, mask, k)
    bits, key, tiles, order = tile_summary(mask)
    skey = key[order.long()]
    new = torch.ones_like(skey, dtype=torch.bool)
    new[1:] = skey[1:] != skey[:-1]
    groups, most = torch.stack([(new & (skey != _EMPTY)).sum(),
                                tiles.max().long()]).tolist()
    return order, bits, groups, most


def split(b: int, n: int, num_sms: int, groups: int | None = None,
          span: int | None = None, shared: bool = False, dense: bool = False
          ) -> tuple[int, int, int]:
    """(keys per chunk, chunks, query rows per block) of pass 1: 64-row
    query tiles, or 4-row ones where 64-row tiles over one 128-key tile each
    would still give fewer blocks than SMs (the IVF probe: 128 queries over
    128 centroids); then whole 128-key tiles per chunk, as few as give
    about ``BLOCKS_PER_SM`` blocks per SM.

    The shared-mask forms (``shared``) take 128-row tensor-core tiles where
    ``b >= TC_MIN_ROWS`` and ``b * n >= TC_MIN_SCORES``, chunked for about
    ``TC_BLOCKS_PER_SM`` blocks an SM (the main path, B=128 over 16,384
    slots: 128 blocks of one tile each); 4-row tiles elsewhere (the IVF
    probe, a few queries, a small slab).

    The interval forms pass ``groups``, the number of distinct non-empty
    intervals, and ``span``, the largest: rows sorted by interval
    (``interval_order``) fill tiles of 64, 32 or 16 rows (the tallest that
    ``b / groups`` rows fill), so a tile covers about one interval; the
    kernel cuts each tile's union of intervals into ``chunks`` runs of whole
    128-key tiles, so chunks are counted over ``span`` keys, not N, for
    about ``GROUPED_BLOCKS_PER_SM[block_q]`` blocks an SM.

    The dense forms (``dense``) pass the same from ``masked_plan``:
    ``groups`` the distinct sort keys, ``span`` the most tiles a row sees
    times ``BLOCK_N``, and take the same tile heights and chunks, at least
    ceil(N / 128 / ``DENSE_LIST``) of them, so that a block's tiles fit its
    list."""
    all_tiles = -(-n // BLOCK_N)
    wide, per_sm = BLOCK_Q, BLOCKS_PER_SM
    if groups is not None:
        rows = b // max(groups, 1)
        wide = next(h for h in BLOCK_Q_INTERVAL
                    if rows >= h or h == BLOCK_Q_INTERVAL[-1])
        n = max(span or 0, 1)
    n_tiles = -(-n // BLOCK_N)
    if shared:
        tc = b >= TC_MIN_ROWS and b * n >= TC_MIN_SCORES
        block_q = BLOCK_Q_TC if tc else BLOCK_Q_NARROW
        per_sm = TC_BLOCKS_PER_SM if tc else BLOCKS_PER_SM
    else:
        block_q = wide if -(-b // wide) * n_tiles >= num_sms \
            else BLOCK_Q_NARROW
    if groups is not None:
        per_sm = GROUPED_BLOCKS_PER_SM[block_q]
    per_chunk, chunks, block_q = chunking(b, n, num_sms, block_q, per_sm)
    least = -(-all_tiles // DENSE_LIST)
    if dense and chunks < least:
        chunks = least
        per_chunk = -(-n_tiles // chunks) * BLOCK_N
    return per_chunk, chunks, block_q


def chunking(b: int, n: int, num_sms: int, block_q: int, per_sm: int
             ) -> tuple[int, int, int]:
    """(keys per chunk, chunks, ``block_q``) for query tiles of ``block_q``
    rows: whole ``BLOCK_N``-key tiles per chunk, as few as give about
    ``per_sm`` blocks an SM."""
    n_tiles, q_tiles = -(-n // BLOCK_N), -(-b // block_q)
    want = max(1, -(-per_sm * num_sms // q_tiles))
    per_chunk = -(-n_tiles // want) * BLOCK_N
    return per_chunk, -(-n // per_chunk), block_q


def _lib() -> ctypes.CDLL:
    lib = build.load("cosine_topk")
    if lib.cosine_topk_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        tail = [i] * 7 + [p] * 5   # B N d k kpc chunks block_q, outputs
        lib.cosine_topk_launch.argtypes = [p, p, i, p] + tail
        lib.cosine_topk_interval_launch.argtypes = [p, p, i, p, p, p, p] + tail
        lib.cosine_topk_masked_launch.argtypes = [p, p, i, p, p, p] + tail
        # q keys scales, then the mask sources
        lib.quant_cosine_topk_launch.argtypes = [p, p, p, p] + tail
        lib.quant_cosine_topk_interval_launch.argtypes = [p] * 7 + tail
        lib.quant_cosine_topk_masked_launch.argtypes = [p] * 6 + tail
        lib.cosine_topk_tile_summary_launch.argtypes = [p, i, i, p, p, p, p,
                                                         p]
        for name in launches:
            getattr(lib, f"{name}_launch").restype = ctypes.c_int
        lib.cosine_topk_error_string.argtypes = [i]
        lib.cosine_topk_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, queries: torch.Tensor, keys: torch.Tensor,
            masks: tuple[torch.Tensor, ...], k: int,
            scales: torch.Tensor | None = None,
            intervals: tuple[int, int] | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel ``name`` on checked operands; ``masks`` are the
    mask-source pointers of its entry point, in order (the interval forms':
    valid, starts, sizes, order; the dense forms': mask, order, tile
    bitmaps). ``scales`` goes to the per-row-scale entry points in place of
    the key type's code; ``intervals`` is the grouped forms' (distinct
    intervals or sort keys, largest span in keys) for ``split``."""
    dev = queries.device
    if dev.type != "cuda":
        raise RuntimeError(f"the CUDA cosine top-k takes CUDA tensors, got "
                           f"{dev}; ops routes CPU tensors to the plain "
                           "version")
    lib = _lib()
    b, d = queries.shape
    n = keys.shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_chunk, chunks, block_q = split(
        b, n, sms, *(intervals or ()),
        shared=name in ("cosine_topk", "quant_cosine_topk"),
        dense=name.endswith("_masked"))
    # one chunk: pass 1 writes the output and pass 2 is not launched
    part_s = part_i = None
    if chunks > 1:
        part_s = torch.empty((b, chunks, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((b, chunks, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    entry = getattr(lib, f"{name}_launch")
    scale_source = (DTYPE_CODE[keys.dtype] if scales is None
                    else scales.data_ptr())
    with torch.cuda.device(dev):
        err = entry(
            queries.data_ptr(), keys.data_ptr(), scale_source,
            *(m.data_ptr() for m in masks), b, n, d, k, per_chunk, chunks,
            block_q, None if part_s is None else part_s.data_ptr(),
            None if part_i is None else part_i.data_ptr(), out_s.data_ptr(),
            out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.cosine_topk_error_string(err).decode()}")
    build.count_launch(launches, name)
    return out_s, out_i


def cosine_topk_cuda(queries: torch.Tensor, keys: torch.Tensor,
                     valid: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k under a shared (N,) ``valid`` mask."""
    check_args(queries, keys, valid, k)
    return _launch("cosine_topk", queries, keys, (valid,), k)


def cosine_topk_interval_cuda(queries: torch.Tensor, keys: torch.Tensor,
                              valid: torch.Tensor, starts: torch.Tensor,
                              sizes: torch.Tensor, k: int
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k where row ``b`` sees ``valid`` within slots
    ``[starts[b], starts[b] + sizes[b])``; ``sizes[b] == 0`` gives exactly
    (-inf, -1). No (B, N) mask is built."""
    order, groups, span = interval_plan(queries, keys, valid, starts, sizes,
                                        k)
    return _launch("cosine_topk_interval", queries, keys,
                   (valid, starts, sizes, order), k,
                   intervals=(groups, span))


def cosine_topk_masked_cuda(queries: torch.Tensor, keys: torch.Tensor,
                            mask: torch.Tensor, k: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k under a dense (B, N) ``mask``, aliveness folded in by the
    caller. Launches pass 0, the ranking of its keys, pass 1 and, over more
    than one chunk, the merge."""
    order, bits, groups, most = masked_plan(queries, keys, mask, k)
    return _launch("cosine_topk_masked", queries, keys, (mask, order, bits),
                   k, intervals=(groups, most * BLOCK_N))


def quant_cosine_topk_cuda(queries: torch.Tensor, keys: torch.Tensor,
                           scales: torch.Tensor, valid: torch.Tensor, k: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``cosine_topk_cuda`` over int8 ``keys`` scaled by ``scales[n]``."""
    check_quant_args(queries, keys, scales, valid, k)
    return _launch("quant_cosine_topk", queries, keys, (valid,), k, scales)


def quant_cosine_topk_interval_cuda(queries: torch.Tensor, keys: torch.Tensor,
                                    scales: torch.Tensor, valid: torch.Tensor,
                                    starts: torch.Tensor, sizes: torch.Tensor,
                                    k: int
                                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``cosine_topk_interval_cuda`` over int8 ``keys`` scaled by
    ``scales[n]``."""
    order, groups, span = interval_plan(queries, keys, valid, starts, sizes,
                                        k, scales)
    return _launch("quant_cosine_topk_interval", queries, keys,
                   (valid, starts, sizes, order), k, scales,
                   intervals=(groups, span))


def quant_cosine_topk_masked_cuda(queries: torch.Tensor, keys: torch.Tensor,
                                  scales: torch.Tensor, mask: torch.Tensor,
                                  k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``cosine_topk_masked_cuda`` over int8 ``keys`` scaled by
    ``scales[n]``."""
    order, bits, groups, most = masked_plan(queries, keys, mask, k, scales)
    return _launch("quant_cosine_topk_masked", queries, keys,
                   (mask, order, bits), k, scales,
                   intervals=(groups, most * BLOCK_N))
