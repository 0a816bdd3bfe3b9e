"""The dense-mask cosine top-k's launch plan, which runs on the CPU: pass 0's
plain version (``ref.visible_tiles_ref``, ``ref.tile_summary_ref``) against
numpy, the row grouping (``cosine_topk.tile_summary``, ``masked_plan``) and
the tile heights ``cosine_topk.split`` picks from it; and
``ExactIndex.search`` with a (B, N) ``alive`` against the JAX package's.
The kernels themselves run only on the card (``test_torch_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.index import ExactIndex as JExactIndex
from repro_torch.core.index import ExactIndex
from repro_torch.kernels import cosine_topk as kmod
from repro_torch.kernels import ref as tref
from test_torch_cuda import make_dense_inputs

SMS = 132   # an H100 SXM


def _np_tiles(mask):
    """Whether each row sees a slot of each 128-key tile, by numpy."""
    b, n = mask.shape
    t = -(-n // 128)
    return np.array([[mask[r, 128 * j:128 * (j + 1)].any() for j in range(t)]
                     for r in range(b)], dtype=bool).reshape(b, t)


def _sparse_mask(b, n, seed):
    """A sparse random mask with an all-False row and a row whose only
    visible slot is the last (in the last, maybe partial, tile)."""
    rng = np.random.default_rng(seed)
    mask = rng.random((b, n)) < 0.003
    mask[0] = False
    if b > 1:
        mask[1] = False
        mask[1, -1] = True
    return mask


@pytest.mark.parametrize("b,n", [(1, 1), (3, 127), (4, 128), (5, 129),
                                 (6, 1000), (3, 4096), (2, 5000)])
def test_visible_tiles_ref_is_numpy_any_over_tiles(b, n):
    mask = _sparse_mask(b, n, seed=n)
    got = tref.visible_tiles_ref(torch.from_numpy(mask))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), _np_tiles(mask))


@pytest.mark.parametrize("b,n", [(1, 1), (3, 127), (5, 129), (6, 1000),
                                 (3, 4096 + 37), (2, 4096 * 3)])
def test_tile_summary_ref_packs_bits_keys_and_counts(b, n):
    mask = _sparse_mask(b, n, seed=b + n)
    tiles = _np_tiles(mask)
    bits, key, seen = tref.tile_summary_ref(torch.from_numpy(mask))
    t = tiles.shape[1]
    assert bits.dtype == torch.int32 and tuple(bits.shape) == (b, -(-t // 32))
    assert key.dtype == torch.int64 and seen.dtype == torch.int32
    words = bits.numpy().view(np.uint32)
    unpacked = (words[:, :, None] >> np.arange(32)) & 1
    np.testing.assert_array_equal(unpacked.reshape(b, -1)[:, :t], tiles)
    assert not unpacked.reshape(b, -1)[:, t:].any()
    np.testing.assert_array_equal(seen.numpy(), tiles.sum(1))
    for r in range(b):
        where = np.flatnonzero(tiles[r])
        if where.size == 0:
            assert key[r] == tref.EMPTY_KEY
        else:
            assert int(key[r]) >> 39 == where[0]
            assert (int(key[r]) >> 15) & ((1 << 24) - 1) == where[-1]
            assert int(key[r]) & ((1 << 15) - 1) == where.size
    # the last row of _sparse_mask's second: its only slot is N - 1
    if b > 1:
        assert int(key[1]) >> 39 == t - 1 and int(seen[1]) == 1
    # a CPU mask takes the plain version through the wrapper, the rows'
    # order a stable sort of the keys
    got = kmod.tile_summary(torch.from_numpy(mask))
    order = torch.sort(key, stable=True).indices.to(torch.int32)
    for g, w in zip(got, (bits, key, seen, order)):
        assert torch.equal(g, w)


def test_tile_summary_keys_order_by_first_last_and_count():
    # rows 0, 2 see tiles {0, 5}; row 1 tiles {0, 2, 5}; row 3 tiles {0, 4,
    # 5}; row 4 tiles {1, 5}: the count tells 0 from 1, row 3 shares row
    # 1's key (pass 1 ORs the real bitmaps), the first tile sets row 4 last
    mask = np.zeros((5, 1000), dtype=bool)
    mask[[0, 2], 3] = True
    mask[[0, 2], 640] = True
    mask[1, [0, 300, 700]] = True
    mask[3, [5, 520, 699]] = True
    mask[4, [130, 650]] = True
    _, key, _ = tref.tile_summary_ref(torch.from_numpy(mask))
    assert key[0] == key[2] and key[1] == key[3]
    assert key[0] < key[1] < key[4]
    assert int(key[1]) == (5 << 15) | 3
    # the count is clamped to 15 bits: 40,000 tiles, one slot each
    wide = torch.zeros((1, 40000 * 128), dtype=torch.bool)
    wide[0, ::128] = True
    _, key, seen = tref.tile_summary_ref(wide)
    assert int(seen[0]) == 40000
    assert int(key[0]) == (39999 << 15) | ((1 << 15) - 1)


def _region_mask(b, n, regions, layout, seed, empty_every=5):
    """Row r sees region r % regions (90% of its slots), every
    ``empty_every``-th row nothing; rows round robin, sorted or at
    random."""
    rng = np.random.default_rng(seed)
    region = np.arange(b) % regions
    if layout == "sorted":
        region = np.sort(region)
    elif layout == "random":
        region = rng.permutation(region)
    size = n // regions
    cols = np.arange(n)[None, :]
    mask = ((cols >= (region * size)[:, None])
            & (cols < (region * size + size)[:, None])
            & (rng.random((b, n)) < 0.9))
    mask[empty_every - 1::empty_every] = False
    return mask


@pytest.mark.parametrize("layout", ["round_robin", "sorted", "random"])
@pytest.mark.parametrize("b", [1, 5, 37, 128])
def test_tile_summary_order_is_a_stable_grouping_permutation(b, layout):
    mask = _region_mask(b, 4096, 4, layout, seed=b)
    bits, _, _, order = kmod.tile_summary(torch.from_numpy(mask))
    assert order.dtype == torch.int32 and tuple(order.shape) == (b,)
    perm = order.long()
    assert torch.equal(torch.sort(perm).values, torch.arange(b))
    assert torch.equal(bits, tref.tile_summary_ref(torch.from_numpy(mask))[0])
    summary = [bits[r].tolist() for r in perm.tolist()]
    blind = [not any(w) for w in summary]
    # rows that see nothing last, in their own order
    n_seen = blind.index(True) if True in blind else b
    assert not any(blind[:n_seen]) and all(blind[n_seen:])
    assert perm[n_seen:].tolist() == sorted(perm[n_seen:].tolist())
    # equal bitmaps side by side, each run in the rows' own order
    runs = []
    for i in range(n_seen):
        if i == 0 or summary[i] != summary[i - 1]:
            runs.append(summary[i])
        else:
            assert perm[i] > perm[i - 1]
    assert len(runs) == len({tuple(w) for w in runs})


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("regions,most", [(1, 32), (4, 8), (8, 4)])
def test_masked_plan_reads_back_groups_and_most_tiles(regions, most, quant):
    mask = torch.from_numpy(_region_mask(128, 4096, regions, "round_robin",
                                         seed=regions))
    q = torch.zeros((128, 8))
    keys = torch.zeros((4096, 8))
    scales = None
    if quant:
        keys, scales = kmod.quantize_keys(keys)
    order, bits, groups, got = kmod.masked_plan(q, keys, mask, 4, scales)
    want_bits, _, _, want_order = kmod.tile_summary(mask)
    assert torch.equal(order, want_order) and torch.equal(bits, want_bits)
    assert groups == regions and got == most
    with pytest.raises(ValueError, match="must have shape"):
        kmod.masked_plan(q, keys[:1000],
                         mask[:, :1000].contiguous()[:100], 4,
                         None if scales is None else scales[:1000])
    with pytest.raises(ValueError, match="must be bool"):
        kmod.masked_plan(q, keys, mask.to(torch.uint8), 4, scales)


def test_masked_plan_of_rows_that_see_nothing():
    mask = torch.zeros((5, 1000), dtype=torch.bool)
    _, _, groups, most = kmod.masked_plan(torch.zeros((5, 8)),
                                          torch.zeros((1000, 8)), mask, 4)
    assert (groups, most) == (0, 0)
    assert kmod.split(5, 1000, SMS, groups, most * kmod.BLOCK_N,
                      dense=True) == (128, 1, 4)


@pytest.mark.parametrize("b,n,regions,want_block_q", [
    (128, 65536, 4, 32),    # the timing shape: 32 rows a region
    (128, 65536, 1, 64),
    (128, 65536, 8, 16),
    (128, 32768, 2, 64),
    (5, 1000, 1, 4),        # a few rows over a few tiles: one warp a row
    (37, 4096, 4, 4),
])
def test_split_from_the_masked_plan(b, n, regions, want_block_q):
    mask = torch.from_numpy(_region_mask(b, n, regions, "round_robin",
                                         seed=b + regions, empty_every=b + 1))
    _, _, groups, most = kmod.masked_plan(torch.zeros((b, 8)),
                                          torch.zeros((n, 8)), mask, 4)
    assert groups == min(regions, b)
    assert most == -(-(n // regions) // kmod.BLOCK_N)
    span = most * kmod.BLOCK_N
    per_chunk, chunks, block_q = kmod.split(b, n, SMS, groups, span,
                                            dense=True)
    assert block_q == want_block_q
    # the interval form's plan at the same visibility, chunked for
    # GROUPED_BLOCKS_PER_SM blocks an SM
    assert (per_chunk, chunks, block_q) == kmod.split(b, n, SMS, groups,
                                                      span)
    assert (per_chunk, chunks, block_q) == kmod.chunking(
        b, span, SMS, block_q, kmod.GROUPED_BLOCKS_PER_SM[block_q])
    assert (chunks - 1) * per_chunk < span <= chunks * per_chunk


@pytest.mark.parametrize("n", [1 << 24, (1 << 27) + 5])
def test_split_keeps_a_dense_block_within_its_tile_list(n):
    # 2,000 rows of one interval a row: few chunks, each over many tiles
    per_chunk, chunks, block_q = kmod.split(2000, n, SMS, 2000, n,
                                            dense=True)
    tiles = -(-n // kmod.BLOCK_N)
    assert chunks * kmod.DENSE_LIST >= tiles
    assert kmod.split(2000, n, SMS, 2000, n)[1] < chunks
    assert chunks * per_chunk >= n and block_q == 16


@pytest.mark.parametrize("layout", ["tenancy", "random", "skewed"])
def test_exact_index_with_a_dense_alive_matches_jax(layout):
    """ExactIndex(backend="torch") with a (B, N) ``alive`` returns what the
    JAX package's jnp ExactIndex returns on the same numpy inputs: ids
    equal, scores within 1e-6 (two f32 summation orders over d=48)."""
    b, n, d, k = 37, 1000, 48, 4
    q, keys, mask, ties = make_dense_inputs(b, n, d, layout, seed=3)
    js, ji = JExactIndex(topk=k, backend="jnp").search(
        None, jnp.asarray(q), jnp.asarray(keys), jnp.asarray(mask))
    ts, ti = ExactIndex(topk=k, backend="torch").search(
        None, torch.from_numpy(q), torch.from_numpy(keys),
        torch.from_numpy(mask))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    for r, want in ties.items():
        assert ti[r, :len(want[:k])].tolist() == want[:k]
    assert bool(torch.all(ti[torch.from_numpy(~mask.any(1))] == -1))
