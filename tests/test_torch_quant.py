"""The port's per-row-scale int8 lookups against the JAX package's:
``quantize_keys`` bitwise against the eager JAX function; the plain
versions of the three per-row-scale kernels (shared mask, per-row interval,
dense per-row mask) and ``ops.quant_cosine_topk`` against
``repro.kernels.ref`` and against the Pallas kernels in interpret mode, on
the same numpy-seeded inputs; the CUDA wrappers' argument checks and launch
counters. The CUDA kernels themselves run only on the card
(``test_torch_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import cosine_topk as jcos
from repro.kernels import ref as jref
from repro_torch.core.index import IVFIndex
from repro_torch.core.types import CacheConfig
from repro_torch.kernels import cosine_topk as kmod
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from test_torch_cuda import (CASES, INTERVAL_CASES, make_inputs,
                             make_interval_inputs)

# the plain version and the JAX oracle and kernel take the same f32 operands
# (int8 times the row's scale) and sum over d <= 384 in other orders
SCORE_TOL = 1e-6
PALLAS = dict(block_b=8, block_n=128, interpret=True)


def _boundary_keys(seed):
    """Random rows, a zero row, and a row whose scale is exactly 1 (absmax
    127) holding values on a .5 rounding boundary, which round half to
    even."""
    rng = np.random.default_rng(seed)
    keys = rng.standard_normal((37, 48)).astype(np.float32)
    keys[5] = 0.0
    keys[9] = 0.0
    keys[9, :10] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5, 3.25,
                    -127.0]
    keys[11] *= 1e-30
    return keys


@pytest.mark.parametrize("shape,seed", [(None, 0), ((4096, 384), 1),
                                        ((1000, 1536), 2)])
def test_quantize_keys_is_bitwise_the_eager_jax_function(shape, seed):
    # The port follows the eager JAX function, which ``ops`` and the JAX
    # tests call. Under ``jax.jit`` XLA rewrites ``absmax / 127.0`` as
    # ``absmax * (1/127)``, one ulp off on some rows (183 of 4,096 scales
    # at (4096, 384)), so the jitted function differs from both.
    if shape is None:
        keys = _boundary_keys(seed)
    else:
        keys = np.random.default_rng(seed).standard_normal(shape).astype(
            np.float32)
    tq, ts = kmod.quantize_keys(torch.from_numpy(keys))
    jq, js = jcos.quantize_keys(jnp.asarray(keys))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    if shape is None:
        assert ts[5].item() == np.float32(np.float32(1e-12) / np.float32(127))
        assert not tq[5].any()
        assert tq[9, :10].tolist() == [127, 2, -4, 0, 0, 2, 126, -126, 3,
                                       -127]


def test_quantize_keys_refuses_what_it_does_not_take():
    with pytest.raises(ValueError):
        kmod.quantize_keys(torch.zeros((4, 8), dtype=torch.float64))
    with pytest.raises(ValueError):
        kmod.quantize_keys(torch.zeros(8))


def _quantized(keys):
    """(int8 keys, scales) of f32 keys, as numpy and as torch."""
    tq, ts = kmod.quantize_keys(torch.from_numpy(keys))
    return tq, ts, tq.numpy(), ts.numpy()


def _same_topk(ts, ti, js, ji):
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=SCORE_TOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("b,n,d,k,mask", CASES)
def test_quant_plain_version_matches_jax_ref_and_pallas(b, n, d, k, mask):
    q, keys, valid, ties = make_inputs(b, n, d, "f32", mask, k, seed=n + k)
    # the planted tie rows are equal in f32, so equal in int8 and scale
    tq, tsc, nq, nsc = _quantized(keys)
    assert bool((tq[ties] == tq[ties[0]]).all())
    assert bool((tsc[ties] == tsc[ties[0]]).all())
    args = (torch.from_numpy(q), tq, tsc, torch.from_numpy(valid))
    ts, ti = tref.quant_cosine_topk_ref(*args, k)
    assert ts.dtype == torch.float32 and ti.dtype == torch.int32
    assert ts.shape == ti.shape == (b, k)
    jargs = tuple(jnp.asarray(x) for x in (q, nq, nsc, valid))
    _same_topk(ts, ti, *jref.quant_cosine_topk_ref(*jargs, k))
    _same_topk(ts, ti, *jcos.quant_cosine_topk_pallas(*jargs, k=k, **PALLAS))
    n_visible = int(valid.sum())
    assert bool(torch.all(ti[:, n_visible:] == -1))
    assert bool(torch.all(torch.isneginf(ts[:, n_visible:])))
    if mask != "none":
        m = min(k, 3, n_visible)
        assert ti[0, :m].tolist() == ties[:m].tolist()
    # ops takes the plain version for CPU tensors, and launches nothing
    before = dict(kmod.launches)
    os_, oi = ops.quant_cosine_topk(*args, k=k)
    assert kmod.launches == before
    assert torch.equal(os_, ts) and torch.equal(oi, ti)


@pytest.mark.parametrize("b,n,d,k", INTERVAL_CASES)
def test_quant_interval_plain_version_matches_jax_ref_and_pallas(b, n, d, k):
    q, keys, valid, starts, sizes, _, ties = make_interval_inputs(
        b, n, d, "f32", k, seed=b + n + k)
    tq, tsc, nq, nsc = _quantized(keys)
    ts, ti = tref.quant_cosine_topk_interval_ref(
        torch.from_numpy(q), tq, tsc, torch.from_numpy(valid),
        torch.from_numpy(starts), torch.from_numpy(sizes), k)
    assert ts.dtype == torch.float32 and ti.dtype == torch.int32
    jargs = tuple(jnp.asarray(x) for x in (q, nq, nsc, valid, starts, sizes))
    _same_topk(ts, ti, *jref.quant_cosine_topk_interval_ref(*jargs, k))
    _same_topk(ts, ti, *jcos.quant_cosine_topk_interval_pallas(*jargs, k=k,
                                                               **PALLAS))
    # size-0 rows are exactly (-inf, -1); ties resolve inside the region
    empty = torch.from_numpy(sizes == 0)
    assert bool(empty.any()) == (b > 4)
    assert bool(torch.all(ti[empty] == -1))
    assert bool(torch.all(torch.isneginf(ts[empty])))
    for r, want in enumerate(ties):
        assert ti[r, :len(want)].tolist() == want.tolist()


@pytest.mark.parametrize("b,n,d,k", INTERVAL_CASES)
def test_quant_dense_mask_plain_version_matches_jax_ref_and_pallas(b, n, d,
                                                                   k):
    q, keys, _, _, sizes, mask, ties = make_interval_inputs(
        b, n, d, "f32", k, seed=b + n + k)
    tq, tsc, nq, nsc = _quantized(keys)
    tqry, tm = torch.from_numpy(q), torch.from_numpy(mask)
    ts, ti = tref.quant_cosine_topk_ref(tqry, tq, tsc, tm, k)
    jargs = tuple(jnp.asarray(x) for x in (q, nq, nsc, mask))
    _same_topk(ts, ti, *jref.quant_cosine_topk_ref(*jargs, k))
    _same_topk(ts, ti, *jcos.quant_cosine_topk_masked_pallas(*jargs, k=k,
                                                             **PALLAS))
    # rows of size 0 see nothing: all (-inf, -1)
    assert bool(torch.all(ti[torch.from_numpy(sizes == 0)] == -1))
    for r, want in enumerate(ties):
        assert ti[r, :len(want)].tolist() == want.tolist()
    # ops.quant_cosine_topk dispatches a (B, N) mask to the masked form
    os_, oi = ops.quant_cosine_topk(tqry, tq, tsc, tm, k=k)
    assert torch.equal(os_, ts) and torch.equal(oi, ti)


def _good():
    keys = torch.ones((16, 8), dtype=torch.int8)
    return (torch.zeros((2, 8)), keys, torch.ones(16),
            torch.ones(16, dtype=torch.bool))


BAD = ["keys_f32", "keys_uniform_bf16", "scales_f64", "scales_len",
       "scales_2d", "scales_noncontig", "scales_other_device", "k0",
       "k_past_max", "valid_len"]


def _bad(bad):
    q, keys, scales, valid = _good()
    k = 4
    if bad == "keys_f32":
        keys = keys.float()
    elif bad == "keys_uniform_bf16":
        keys = keys.to(torch.bfloat16)
    elif bad == "scales_f64":
        scales = scales.double()
    elif bad == "scales_len":
        scales = scales[:15]
    elif bad == "scales_2d":
        scales = scales[:, None]
    elif bad == "scales_noncontig":
        scales = torch.ones(32)[::2]
    elif bad == "scales_other_device":
        scales = torch.empty(16, device="meta")
    elif bad == "k0":
        k = 0
    elif bad == "k_past_max":
        k = kmod.MAX_K + 1
    else:
        valid = valid[:15]
    return q, keys, scales, valid, k


@pytest.mark.parametrize("bad", BAD)
def test_quant_wrappers_refuse_what_the_kernels_do_not_take(bad):
    q, keys, scales, valid, k = _bad(bad)
    b, n = q.shape[0], keys.shape[0]
    starts = torch.zeros(b, dtype=torch.int32)
    sizes = torch.full((b,), min(n, valid.shape[0]), dtype=torch.int32)
    mask = valid[None].repeat(b, 1)
    before = dict(kmod.launches)
    with pytest.raises(ValueError):
        kmod.quant_cosine_topk_cuda(q, keys, scales, valid, k)
    with pytest.raises(ValueError):
        kmod.quant_cosine_topk_interval_cuda(q, keys, scales, valid, starts,
                                             sizes, k)
    with pytest.raises(ValueError):
        kmod.quant_cosine_topk_masked_cuda(q, keys, scales, mask, k)
    with pytest.raises(ValueError):
        ops.quant_cosine_topk(q, keys, scales, valid, k=k)
    with pytest.raises(ValueError):
        ops.quant_cosine_topk(q, keys, scales, mask, k=k)
    assert kmod.launches == before


@pytest.mark.parametrize("bad", ["past_end", "starts_i64"])
def test_quant_interval_wrapper_refuses_bad_intervals(bad):
    q, keys, scales, valid = _good()
    starts = torch.tensor([0, 8], dtype=torch.int32)
    sizes = torch.tensor([8, 9 if bad == "past_end" else 8],
                         dtype=torch.int32)
    if bad == "starts_i64":
        starts = starts.long()
    with pytest.raises(ValueError):
        kmod.quant_cosine_topk_interval_cuda(q, keys, scales, valid, starts,
                                             sizes, 4)


def test_quant_wrappers_take_cuda_tensors_only():
    q, keys, scales, valid = _good()
    starts = torch.zeros(2, dtype=torch.int32)
    sizes = torch.full((2,), 16, dtype=torch.int32)
    before = dict(kmod.launches)
    with pytest.raises(RuntimeError, match="CUDA"):
        kmod.quant_cosine_topk_cuda(q, keys, scales, valid, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        kmod.quant_cosine_topk_interval_cuda(q, keys, scales, valid, starts,
                                             sizes, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        kmod.quant_cosine_topk_masked_cuda(q, keys, scales,
                                           valid[None].repeat(2, 1), 4)
    assert kmod.launches == before


def test_quant_launch_counters_are_per_kernel():
    names = ("quant_cosine_topk", "quant_cosine_topk_interval",
             "quant_cosine_topk_masked")
    assert set(names) <= set(kmod.launches)
    kmod.reset_launches()
    for i, name in enumerate(names):
        kmod.launches[name] += i + 1
    assert kmod.launches == {**dict.fromkeys(kmod.launches, 0),
                             **dict(zip(names, (1, 2, 3)))}
    kmod.reset_launches()
    assert kmod.launches == dict.fromkeys(kmod.launches, 0)


def test_ivf_index_init_resolves_its_device(monkeypatch):
    cfg = CacheConfig(dim=16, capacity=64)
    idx = IVFIndex(ncentroids=4, bucket_cap=8)
    st = idx.init(cfg, "cpu")
    assert {t.device.type for t in (st.centroids, st.buckets,
                                    st.bucket_valid)} == {"cpu"}
    # no device means CUDA, as at every entry point; without CUDA it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        idx.init(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        idx.init(cfg, None)
