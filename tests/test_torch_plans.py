"""The launch plans of the port's CUDA kernels, which run on the CPU: the
decode-attention split chooser (``decode_attention.split``), and the interval
cosine top-k's row grouping (``cosine_topk.interval_order``, the read-back
plan, and the tile heights ``cosine_topk.split`` picks from it). The kernels
themselves run only on the card (``test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cosine_topk as kmod
from repro_torch.kernels import decode_attention as kdec

SMS = 132   # an H100 SXM


# --------------------------------------------------------------------- #
# decode attention: splits of the cache
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("b,s,hkv,d,kv_bytes", [
    (39, 96, 4, 128, 2),      # the serve path, yi-6b
    (20, 96, 4, 128, 2),      # about the fewest misses a batch
    (8, 4096, 4, 128, 2),     # yi-6b's published context
    (1, 96, 4, 128, 2),
    (2, 1, 2, 64, 4),
    (3, 16, 2, 64, 4),
    (3, 17, 2, 64, 4),
    (2, 512, 2, 64, 4),
    (2, 128, 1, 256, 4),      # G=16, D=256, f32: 32-slot tiles
    (1, 1024, 1, 256, 2),
    (2, 4096, 4, 128, 1),     # int8
    (1, 20000, 1, 64, 2),     # more splits than MAX_SPLITS would allow
    (400, 4096, 8, 128, 2),   # more (b, kv-head) pairs than SMs
])
def test_decode_split(b, s, hkv, d, kv_bytes):
    n_split, tile = kdec.split(s, d, kv_bytes)
    assert 1 <= n_split <= min(s, kdec.MAX_SPLITS)
    longest = -(-s // n_split)
    shortest = s // n_split
    # at least MIN_SLOTS (>= 16) slots in every split, or one split
    assert kdec.MIN_SLOTS >= 16
    assert n_split == 1 or shortest >= kdec.MIN_SLOTS
    if s <= 16:
        assert n_split == 1
    # as many splits as that allows: >= 2 blocks an SM wherever S allows
    allowed = max(1, min(s // kdec.MIN_SLOTS, kdec.MAX_SPLITS))
    assert n_split == allowed
    if b * hkv * allowed >= 2 * SMS:
        assert b * hkv * n_split >= 2 * SMS
    # tiles within the byte budget, balanced over the longest split; one
    # tile a split where MAX_SPLITS does not bind and a tile holds MIN_SLOTS
    most = min(kdec.MAX_TILE, kdec.TILE_BYTES // (2 * d * kv_bytes))
    assert 1 <= tile <= most
    tiles = -(-longest // tile)
    assert tiles == -(-longest // most)
    assert tile * (tiles - 1) < longest <= tile * tiles
    if s // kdec.MIN_SLOTS <= kdec.MAX_SPLITS and most >= 2 * kdec.MIN_SLOTS:
        assert tiles == 1


def test_decode_split_keeps_short_caches_whole():
    # below 2 * MIN_SLOTS slots a merge costs more than it saves (PERF.md)
    for s in range(1, 2 * kdec.MIN_SLOTS):
        assert kdec.split(s, 128, 2)[0] == 1
    assert kdec.split(2 * kdec.MIN_SLOTS, 128, 2)[0] == 2


def test_decode_scratch_shapes():
    q = torch.zeros((3, 1, 8, 64))
    assert kdec.scratch(q, 1, 2) == (None, None)
    part_acc, part_ml = kdec.scratch(q, 5, 2)
    assert tuple(part_acc.shape) == (3, 2, 5, 4, 64)
    assert tuple(part_ml.shape) == (3, 2, 5, 4, 2)
    assert part_acc.dtype == part_ml.dtype == torch.float32


# --------------------------------------------------------------------- #
# interval cosine top-k: rows grouped by interval
# --------------------------------------------------------------------- #
def _intervals(b, layout, seed, regions=4, n=4096):
    """(starts, sizes) of b rows over `regions` equal slab regions; every
    fifth row empty; rows round robin, sorted or at random."""
    rng = np.random.default_rng(seed)
    size = n // regions
    tenant = np.arange(b) % regions
    if layout == "sorted":
        tenant = np.sort(tenant)
    elif layout == "random":
        tenant = rng.permutation(tenant)
    starts = (tenant * size).astype(np.int32)
    sizes = np.full(b, size, np.int32)
    sizes[4::5] = 0
    starts[9::10] = 0   # empty rows with another start
    return torch.from_numpy(starts), torch.from_numpy(sizes)


@pytest.mark.parametrize("layout", ["round_robin", "sorted", "random"])
@pytest.mark.parametrize("b", [1, 5, 37, 128])
def test_interval_order(b, layout):
    starts, sizes = _intervals(b, layout, seed=b)
    order = kmod.interval_order(starts, sizes)
    assert order.dtype == torch.int32 and tuple(order.shape) == (b,)
    perm = order.long()
    assert torch.equal(torch.sort(perm).values, torch.arange(b))
    st, sz = starts[perm], sizes[perm]
    empty = sz == 0
    # empty rows last, in their own order
    n_full = int((~empty).sum())
    assert not bool(empty[:n_full].any()) and bool(empty[n_full:].all())
    assert torch.equal(perm[n_full:], torch.sort(perm[n_full:]).values)
    # sorted by (start, size): equal intervals contiguous, stable within
    key = st[:n_full].long() * (1 << 32) + sz[:n_full].long()
    assert bool((key[1:] >= key[:-1]).all())
    for i in range(1, n_full):
        if key[i] == key[i - 1]:
            assert perm[i] > perm[i - 1]


def test_interval_order_is_stable_for_equal_starts():
    starts = torch.tensor([8, 0, 8, 0, 8, 0], dtype=torch.int32)
    sizes = torch.tensor([4, 8, 2, 8, 4, 0], dtype=torch.int32)
    order = kmod.interval_order(starts, sizes).tolist()
    # (0, 8) rows 1, 3; (8, 2) row 2; (8, 4) rows 0, 4; empty row 5
    assert order == [1, 3, 2, 0, 4, 5]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("layout", ["round_robin", "random"])
def test_interval_plan_reads_back_groups_and_span(layout, quant):
    starts, sizes = _intervals(128, layout, seed=3)
    q = torch.zeros((128, 8))
    keys = torch.zeros((4096, 8))
    scales = None
    if quant:
        keys, scales = kmod.quantize_keys(keys)
    valid = torch.ones(4096, dtype=torch.bool)
    order, groups, span = kmod.interval_plan(q, keys, valid, starts, sizes,
                                             4, scales)
    assert torch.equal(order, kmod.interval_order(starts, sizes))
    assert groups == 4 and span == 1024
    with pytest.raises(ValueError, match="every interval must lie within"):
        kmod.interval_plan(q, keys[:1000], valid[:1000], starts, sizes, 4,
                           None if scales is None else scales[:1000])
    with pytest.raises(ValueError, match="must be"):
        kmod.interval_plan(q, keys, valid, starts.long(), sizes, 4, scales)


@pytest.mark.parametrize("b,groups,span,expect", [
    # (keys per chunk, chunks, query rows per block)
    (128, 4, 16384, (256, 64, 32)),    # the tenancy path: 32 rows a region
    (128, 1, 65536, (512, 128, 64)),   # one interval
    (128, 2, 32768, (256, 128, 64)),
    (128, 8, 8192, (128, 64, 16)),
    (128, 40, 1000, (128, 8, 4)),      # few keys: one warp a row
    (37, 3, 334, (128, 3, 4)),
    (5, 0, 0, (128, 1, 4)),            # every row empty
])
def test_split_from_grouped_intervals(b, groups, span, expect):
    got = kmod.split(b, 65536, SMS, groups, span)
    assert got == expect
    per_chunk, chunks, block_q = got
    assert per_chunk % kmod.BLOCK_N == 0
    assert (chunks - 1) * per_chunk < max(span, 1) <= chunks * per_chunk
    if block_q != kmod.BLOCK_Q_NARROW:
        assert block_q in kmod.BLOCK_Q_INTERVAL
        assert b // max(groups, 1) >= block_q or block_q == 16
    # about GROUPED_BLOCKS_PER_SM blocks an SM, where the span allows
    blocks = chunks * -(-b // block_q)
    if chunks < -(-max(span, 1) // kmod.BLOCK_N):
        assert blocks >= kmod.GROUPED_BLOCKS_PER_SM[block_q] * SMS * 0.9
