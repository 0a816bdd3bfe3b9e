"""The port's cosine top-k against the JAX package's: the plain PyTorch
versions (shared mask, per-row interval, dense per-row mask) against
``repro.kernels.ref`` and against the Pallas kernels in interpret mode, on
the same numpy-seeded inputs; the CUDA wrappers' argument checks; the
device dispatch. The CUDA kernels themselves run only on the card
(``test_torch_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.index import ExactIndex as JExactIndex
from repro.kernels import ref as jref
from repro.kernels.cosine_topk import (cosine_topk_interval_pallas,
                                       cosine_topk_masked_pallas,
                                       cosine_topk_pallas)
from repro_torch.core.index import ExactIndex
from repro_torch.core.similarity import masked_topk
from repro_torch.kernels import cosine_topk as kmod
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from test_torch_cuda import (CASES, INTERVAL_CASES, keys_to_torch,
                             make_inputs, make_interval_inputs)

SCORE_TOL = 1e-6   # two f32 summation orders over d <= 384


def _to_jax(keys, key_dtype):
    return jnp.asarray(keys, dtype=jnp.bfloat16 if key_dtype == "bf16"
                       else None)


@pytest.mark.parametrize("key_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("b,n,d,k,mask", CASES)
def test_plain_version_matches_jax_ref_and_pallas(b, n, d, k, mask,
                                                  key_dtype):
    q, keys, valid, ties = make_inputs(b, n, d, key_dtype, mask, k, seed=n + k)
    ts, ti = tref.cosine_topk_ref(torch.from_numpy(q),
                                  keys_to_torch(keys, key_dtype),
                                  torch.from_numpy(valid), k)
    assert ts.dtype == torch.float32 and ti.dtype == torch.int32
    assert ts.shape == ti.shape == (b, k)
    jk = _to_jax(keys, key_dtype)
    js, ji = jref.cosine_topk_ref(jnp.asarray(q), jk, jnp.asarray(valid), k)
    ps, pi = cosine_topk_pallas(jnp.asarray(q), jk, jnp.asarray(valid), k=k,
                                block_b=8, block_n=128, interpret=True)
    for s, i in ((js, ji), (ps, pi)):
        np.testing.assert_allclose(ts.numpy(), np.asarray(s), rtol=0,
                                   atol=SCORE_TOL)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(i))
    n_visible = int(valid.sum())
    assert bool(torch.all(ti[:, n_visible:] == -1))
    assert bool(torch.all(torch.isneginf(ts[:, n_visible:])))
    if mask != "none":
        # the planted exact ties come back in slot order, lowest first
        m = min(k, 3, n_visible)
        assert ti[0, :m].tolist() == ties[:m].tolist()


def test_masked_topk_breaks_ties_to_the_lowest_index():
    scores = torch.tensor([[0.5, 0.9, 0.5, 0.9, float("-inf"), 0.5]])
    vals, idx = masked_topk(scores, 5)
    assert idx.tolist() == [[1, 3, 0, 2, 5]]
    assert torch.equal(vals, scores[:, [1, 3, 0, 2, 5]])


def _good():
    return (torch.zeros((2, 8)), torch.zeros((16, 8)),
            torch.ones(16, dtype=torch.bool))


@pytest.mark.parametrize("bad", [
    "queries_f64", "keys_f16", "valid_u8", "valid_2d", "keys_1d",
    "dim_mismatch", "valid_len", "k0", "k9", "noncontig"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    q, keys, valid = _good()
    k = 4
    if bad == "queries_f64":
        q = q.double()
    elif bad == "keys_f16":
        keys = keys.half()
    elif bad == "valid_u8":
        valid = valid.to(torch.uint8)
    elif bad == "valid_2d":
        # a per-row mask must have one row per query
        valid = torch.ones((3, 16), dtype=torch.bool)
    elif bad == "keys_1d":
        keys = keys[0]
    elif bad == "dim_mismatch":
        keys = torch.zeros((16, 9))
    elif bad == "valid_len":
        valid = valid[:15]
    elif bad == "k0":
        k = 0
    elif bad == "k9":
        k = 9
    else:
        keys = torch.zeros((8, 16)).T
    with pytest.raises(ValueError):
        kmod.cosine_topk_cuda(q, keys, valid, k)
    with pytest.raises(ValueError):
        ops.cosine_topk(q, keys, valid, k=k)


def test_wrapper_takes_cuda_tensors_only():
    q, keys, valid = _good()
    starts = torch.zeros(2, dtype=torch.int32)
    sizes = torch.full((2,), 16, dtype=torch.int32)
    before = dict(kmod.launches)
    with pytest.raises(RuntimeError, match="CUDA"):
        kmod.cosine_topk_cuda(q, keys, valid, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        kmod.cosine_topk_interval_cuda(q, keys, valid, starts, sizes, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        kmod.cosine_topk_masked_cuda(q, keys, valid[None].repeat(2, 1), 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        ExactIndex(backend="kernel").search(None, q, keys, valid)
    with pytest.raises(RuntimeError, match="CUDA"):
        ExactIndex(backend="kernel").search(None, q, keys, valid,
                                            interval=(starts, sizes))
    assert kmod.launches == before


def test_ops_sends_cpu_tensors_to_the_plain_version():
    q, keys, valid, _ = make_inputs(4, 200, 32, "f32", "random", 4, seed=3)
    args = (torch.from_numpy(q), torch.from_numpy(keys),
            torch.from_numpy(valid))
    before = dict(kmod.launches)
    s, i = ops.cosine_topk(*args, k=4)
    rs, ri = tref.cosine_topk_ref(*args, 4)
    assert kmod.launches == before
    assert torch.equal(s, rs) and torch.equal(i, ri)
    es, ei = ExactIndex(topk=4).search(None, *args)
    ts, ti = ExactIndex(topk=4, backend="torch").search(None, *args)
    assert torch.equal(es, ts) and torch.equal(ei, ti)


@pytest.mark.parametrize("b,n,expect_blocks", [(128, 16384, 256),
                                               (1, 1000, 8),
                                               (200, 1048576, 524)])
def test_split_covers_the_slab_in_whole_tiles(b, n, expect_blocks):
    per_chunk, chunks = kmod.split(b, n, num_sms=132)
    assert per_chunk % kmod.BLOCK_N == 0
    assert (chunks - 1) * per_chunk < n <= chunks * per_chunk
    assert chunks * -(-b // kmod.BLOCK_Q) == expect_blocks


def _interval_torch(q, keys, valid, starts, sizes, mask, key_dtype):
    return (torch.from_numpy(q), keys_to_torch(keys, key_dtype),
            torch.from_numpy(valid), torch.from_numpy(starts),
            torch.from_numpy(sizes), torch.from_numpy(mask))


def _same_topk(ts, ti, js, ji):
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=SCORE_TOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("key_dtype", ["f32", "int8"])
@pytest.mark.parametrize("b,n,d,k", INTERVAL_CASES)
def test_interval_plain_version_matches_jax_ref_and_pallas(b, n, d, k,
                                                           key_dtype):
    q, keys, valid, starts, sizes, mask, ties = make_interval_inputs(
        b, n, d, key_dtype, k, seed=b + n + k)
    tq, tk, tv, tst, tsz, _ = _interval_torch(q, keys, valid, starts, sizes,
                                              mask, key_dtype)
    np.testing.assert_array_equal(
        tref.interval_mask(tst, tsz, n).numpy(),
        np.asarray(jref.interval_mask(jnp.asarray(starts),
                                      jnp.asarray(sizes), n)))
    ts, ti = tref.cosine_topk_interval_ref(tq, tk, tv, tst, tsz, k)
    assert ts.dtype == torch.float32 and ti.dtype == torch.int32
    jargs = tuple(jnp.asarray(x) for x in (q, keys, valid, starts, sizes))
    _same_topk(ts, ti, *jref.cosine_topk_interval_ref(*jargs, k))
    _same_topk(ts, ti, *cosine_topk_interval_pallas(
        *jargs, k=k, block_b=8, block_n=128, interpret=True))
    # size-0 rows are exactly (-inf, -1); ties resolve inside the region
    empty = torch.from_numpy(sizes == 0)
    assert bool(torch.all(ti[empty] == -1))
    assert bool(torch.all(torch.isneginf(ts[empty])))
    for r, want in enumerate(ties):
        assert ti[r, :len(want)].tolist() == want.tolist()
    # the ops dispatch takes the same plain version for CPU tensors
    os_, oi = ops.cosine_topk_interval(tq, tk, tv, tst, tsz, k=k)
    assert torch.equal(os_, ts) and torch.equal(oi, ti)


@pytest.mark.parametrize("key_dtype", ["f32", "int8"])
@pytest.mark.parametrize("b,n,d,k", INTERVAL_CASES)
def test_dense_mask_plain_version_matches_jax_ref_and_pallas(b, n, d, k,
                                                             key_dtype):
    q, keys, _, _, sizes, mask, ties = make_interval_inputs(
        b, n, d, key_dtype, k, seed=b + n + k)
    tq, tk = torch.from_numpy(q), keys_to_torch(keys, key_dtype)
    tm = torch.from_numpy(mask)
    ts, ti = tref.cosine_topk_ref(tq, tk, tm, k)
    jq, jk, jm = (jnp.asarray(x) for x in (q, keys, mask))
    _same_topk(ts, ti, *jref.cosine_topk_ref(jq, jk, jm, k))
    _same_topk(ts, ti, *cosine_topk_masked_pallas(
        jq, jk, jm, k=k, block_b=8, block_n=128, interpret=True))
    assert bool(torch.all(ti[torch.from_numpy(sizes == 0)] == -1))
    for r, want in enumerate(ties):
        assert ti[r, :len(want)].tolist() == want.tolist()
    # the repair: ops.cosine_topk takes a (B, N) mask, as the JAX one does
    os_, oi = ops.cosine_topk(tq, tk, tm, k=k)
    assert torch.equal(os_, ts) and torch.equal(oi, ti)


@pytest.mark.parametrize("with_interval", [False, True])
def test_exact_index_takes_a_per_row_alive_mask(with_interval):
    """ExactIndex.search with a (B, N) ``alive`` returns what the JAX one
    returns; an interval on top of it is folded in, never dropped."""
    b, n, d, k = 13, 517, 48, 4
    q, keys, valid, starts, sizes, mask, _ = make_interval_inputs(
        b, n, d, "f32", k, seed=5)
    alive = mask | (np.random.default_rng(6).random((b, n)) < 0.3)
    interval = (starts, sizes) if with_interval else None
    js, ji = JExactIndex(topk=k, backend="jnp").search(
        None, jnp.asarray(q), jnp.asarray(keys), jnp.asarray(alive),
        interval=None if interval is None
        else tuple(jnp.asarray(x) for x in interval))
    for backend in ("auto", "torch"):
        ts, ti = ExactIndex(topk=k, backend=backend).search(
            None, torch.from_numpy(q), torch.from_numpy(keys),
            torch.from_numpy(alive),
            interval=None if interval is None
            else tuple(torch.from_numpy(x) for x in interval))
        _same_topk(ts, ti, js, ji)
    if with_interval:
        assert bool(torch.all(ti[torch.from_numpy(sizes == 0)] == -1))


@pytest.mark.parametrize("bad", ["starts_i64", "sizes_len", "past_end",
                                 "negative_size", "negative_start",
                                 "wraps_int32"])
def test_interval_wrapper_refuses_bad_intervals(bad):
    q, keys, valid = _good()
    starts = torch.tensor([0, 8], dtype=torch.int32)
    sizes = torch.tensor([8, 8], dtype=torch.int32)
    if bad == "starts_i64":
        starts = starts.long()
    elif bad == "sizes_len":
        sizes = sizes[:1]
    elif bad == "past_end":
        sizes = torch.tensor([8, 9], dtype=torch.int32)
    elif bad == "negative_size":
        sizes = torch.tensor([-1, 8], dtype=torch.int32)
    elif bad == "wraps_int32":
        # starts + sizes wraps to a negative int32
        starts = torch.tensor([0, 2 ** 31 - 2], dtype=torch.int32)
    else:
        starts = torch.tensor([-1, 8], dtype=torch.int32)
    with pytest.raises(ValueError):
        kmod.cosine_topk_interval_cuda(q, keys, valid, starts, sizes, 4)
    with pytest.raises(ValueError):
        ops.cosine_topk_interval(q, keys, valid, starts, sizes, k=4)


def test_launch_counters_are_per_kernel():
    kmod.launches["cosine_topk_interval"] += 3
    assert set(kmod.launches) == {"cosine_topk", "cosine_topk_interval",
                                  "cosine_topk_masked"}
    kmod.reset_launches()
    assert kmod.launches == dict.fromkeys(kmod.launches, 0)
