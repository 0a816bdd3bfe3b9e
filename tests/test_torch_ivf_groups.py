"""The IVF kernel's grouping on the CPU. ``IVFIndex.probe_candidates``
against ``candidates`` and the JAX package's; ``ops.ivf_topk`` given the
probe and the bucket table against itself without them, against
``repro.kernels.ref.ivf_topk_ref`` and against the JAX
``IVFIndex(backend="jnp").search``; the contract check of the plain route;
the wrapper's refusals; and ``IVFIndex.search`` handing the grouping to the
kernel. The bucket-major CUDA kernel itself runs on the card in
``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.index import IVFState as JIVFState
from repro.kernels import ref as jref
from repro_torch.core.similarity import l2_normalize
from repro_torch.kernels import ivf_topk as kivf
from repro_torch.kernels import ops
from test_torch_cuda import (GROUPED_CASES, assert_topk_close,
                             keys_to_torch, make_grouped_ivf_inputs)
from test_torch_ivf import (SCORE_TOL, _fitted, _jax_keys, _to_torch_state,
                            _unit)
from test_torch_store_cache import _assert_same

VISIBILITY = ["shared", "per_row", "interval", "dead_buckets"]


def _index_inputs(visibility, key_dtype="f32"):
    """A fitted JAX IVF index with recycled slots (as ``absorb`` leaves
    them), its port twin, the slab, nine queries and their visibility, as
    ``test_torch_ivf.test_candidates_match_jax`` builds them."""
    jidx, tidx, jst, keys, alive = _fitted(c=6, cap=16, n=60, seed=2,
                                           key_dtype=key_dtype)
    rng = np.random.default_rng(5)
    emb = _unit(rng, (12, 16))
    slots = rng.integers(0, 60, 12).astype(np.int32)
    jst = jidx.absorb(jst, jnp.asarray(slots), jnp.asarray(emb),
                      jnp.ones(12, bool))
    if visibility == "dead_buckets":
        jst = JIVFState(jst.centroids, jst.buckets,
                        jst.bucket_valid.at[1].set(False).at[4, 3:].set(False))
    q = _unit(rng, (9, 16))
    valid, interval = alive & (rng.random(64) < 0.8), None
    if visibility == "per_row":
        valid = alive[None, :] & (rng.random((9, 64)) < 0.7)
    elif visibility == "interval":
        interval = (np.array([0, 20, 40] * 3, np.int32),
                    np.array([20, 20, 24, 0, 20, 24, 20, 0, 24], np.int32))
    return jidx, tidx, jst, _to_torch_state(jst), keys, q, valid, interval


def _jax(interval):
    return None if interval is None else tuple(jnp.asarray(x)
                                               for x in interval)


def _torch(interval):
    return None if interval is None else tuple(torch.from_numpy(x)
                                               for x in interval)


@pytest.mark.parametrize("visibility", VISIBILITY)
def test_probe_candidates_match_candidates_and_jax(visibility):
    """cand equals ``candidates()`` and the JAX ``IVFIndex.candidates``;
    the probe equals the port's centroid probe and the JAX oracle's, and
    the two keep the grouping contract."""
    jidx, tidx, jst, tst, _, q, valid, interval = _index_inputs(visibility)
    tq, tv = torch.from_numpy(q), torch.from_numpy(valid)
    cand, probe = tidx.probe_candidates(tst, tq, tv,
                                        interval=_torch(interval))
    assert torch.equal(cand, tidx.candidates(tst, tq, tv,
                                             interval=_torch(interval)))
    jc = jidx.candidates(jst, jnp.asarray(q), jnp.asarray(valid),
                         interval=_jax(interval))
    _assert_same(jc, cand, "candidates")
    p = min(tidx.nprobe, tidx.ncentroids)
    always = torch.ones(tst.centroids.shape[0], dtype=torch.bool)
    assert probe.dtype == torch.int32 and probe.shape == (9, p)
    assert torch.equal(probe, ops.cosine_topk(tq, tst.centroids, always,
                                              k=p)[1])
    _, jprobe = jref.cosine_topk_ref(jnp.asarray(q), jst.centroids,
                                     jnp.ones(jst.centroids.shape[0], bool),
                                     p)
    _assert_same(jprobe, probe, "probe")
    kivf.check_contract(cand, probe, tst.buckets)


@pytest.mark.parametrize("key_dtype", ["f32", "int8"])
@pytest.mark.parametrize("visibility", VISIBILITY)
def test_grouped_ivf_topk_matches_ungrouped_ref_and_jax(visibility,
                                                        key_dtype):
    """Given the grouping, the plain route returns what it returns without
    it, bit for bit; that equals ``repro.kernels.ref.ivf_topk_ref`` on the
    same ids and the JAX ``IVFIndex(backend="jnp").search`` (scores within
    1e-6, ids equal)."""
    jidx, tidx, jst, tst, keys, q, valid, interval = _index_inputs(
        visibility, key_dtype)
    tq, tk = l2_normalize(torch.from_numpy(q)), torch.from_numpy(keys)
    cand, probe = tidx.probe_candidates(tst, tq, torch.from_numpy(valid),
                                        interval=_torch(interval))
    k = tidx.topk
    grouped = ops.ivf_topk(tq, tk, cand, k=k, probe=probe,
                           buckets=tst.buckets)
    plain = ops.ivf_topk(tq, tk, cand, k=k)
    assert torch.equal(grouped[0], plain[0]) and torch.equal(grouped[1],
                                                             plain[1])
    js, ji = jref.ivf_topk_ref(jnp.asarray(q), jnp.asarray(keys),
                               jnp.asarray(cand.numpy()), k)
    np.testing.assert_allclose(grouped[0].numpy(), np.asarray(js), rtol=0,
                               atol=1e-6)
    _assert_same(ji, grouped[1], "ivf_topk ids")
    js, ji = jidx.search(jst, jnp.asarray(q), jnp.asarray(keys),
                         jnp.asarray(valid), interval=_jax(interval))
    ts, ti = tidx.search(tst, torch.from_numpy(q), tk,
                         torch.from_numpy(valid),
                         interval=_torch(interval))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=1e-6)
    _assert_same(ji, ti, "search ids")
    assert torch.equal(ts, grouped[0]) and torch.equal(ti, grouped[1])


@pytest.mark.parametrize("key_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", GROUPED_CASES)
def test_grouped_plain_route_on_synthetic_tables(case, key_dtype):
    """The card tests' seeded tables (a full bucket probed by every row, an
    empty one, cap 16/100/37/24, k up to 32): the grouped plain route equals
    the ungrouped one and the JAX oracle, and the planted ties across two
    buckets go to the lower position."""
    q, keys, cand, probe, buckets, ties = make_grouped_ivf_inputs(
        *case, key_dtype, seed=sum(case))
    k = case[-1]
    tq, tk = torch.from_numpy(q), keys_to_torch(keys, key_dtype)
    tc = torch.from_numpy(cand)
    grouped = ops.ivf_topk(tq, tk, tc, k=k, probe=torch.from_numpy(probe),
                           buckets=torch.from_numpy(buckets))
    plain = ops.ivf_topk(tq, tk, tc, k=k)
    assert torch.equal(grouped[0], plain[0]) and torch.equal(grouped[1],
                                                             plain[1])
    js, ji = jref.ivf_topk_ref(jnp.asarray(q), _jax_keys(keys, key_dtype),
                               jnp.asarray(cand), k + 1)
    assert_topk_close(grouped, (torch.from_numpy(np.array(js)),
                                torch.from_numpy(np.array(ji))), k,
                      SCORE_TOL[key_dtype])
    for r, want in ties.items():
        assert grouped[1][r, :len(want)].tolist() == want


@pytest.mark.parametrize("bad", ["other_slot", "probe_past_table",
                                 "negative_probe", "visible_in_hole"])
def test_contract_violation_raises_on_the_cpu(bad):
    """A cand entry that is neither -1 nor its bucket member, or a probe
    outside the table, is refused by the plain route; the same operands
    without the grouping are searched as they are."""
    q, keys, cand, probe, buckets, _ = make_grouped_ivf_inputs(
        *GROUPED_CASES[1], "f32", seed=3)
    cap = buckets.shape[1]
    if bad == "other_slot":
        b, pos = np.argwhere(cand >= 0)[7]
        cand[b, pos] = (cand[b, pos] + 1) % keys.shape[0]
    elif bad == "probe_past_table":
        probe[4, 2] = buckets.shape[0]
    elif bad == "negative_probe":
        probe[4, 2] = -1
    else:  # an id where the probed bucket has no member
        b, j = 5, 1
        t = np.flatnonzero(buckets[probe[b, j]] < 0)[0]
        cand[b, j * cap + t] = 0
    args = (torch.from_numpy(q), torch.from_numpy(keys),
            torch.from_numpy(cand))
    with pytest.raises(ValueError):
        ops.ivf_topk(*args, k=4, probe=torch.from_numpy(probe),
                     buckets=torch.from_numpy(buckets))
    ops.ivf_topk(*args, k=4)


@pytest.mark.parametrize("bad", ["probe_i64", "buckets_i64", "probe_rows",
                                 "m_mismatch", "p_over_max", "probe_alone",
                                 "buckets_alone", "probe_1d", "noncontig",
                                 "buckets_1d", "zero_probes", "empty_table",
                                 "buckets_noncontig"])
def test_ivf_topk_refuses_bad_probe_and_buckets(bad):
    q, keys = torch.zeros((2, 8)), torch.zeros((16, 8))
    cand = torch.zeros((2, 6), dtype=torch.int32)
    probe = torch.zeros((2, 2), dtype=torch.int32)
    buckets = torch.zeros((4, 3), dtype=torch.int32)
    ops.ivf_topk(q, keys, cand, k=4, probe=probe, buckets=buckets)
    if bad == "probe_i64":
        probe = probe.long()
    elif bad == "buckets_i64":
        buckets = buckets.long()
    elif bad == "probe_rows":
        probe = probe[:1]
    elif bad == "m_mismatch":
        buckets = torch.zeros((4, 4), dtype=torch.int32)
    elif bad == "p_over_max":
        probe = torch.zeros((2, kivf.MAX_P + 1), dtype=torch.int32)
        buckets = torch.zeros((4, 1), dtype=torch.int32)
        cand = torch.zeros((2, kivf.MAX_P + 1), dtype=torch.int32)
    elif bad == "probe_alone":
        buckets = None
    elif bad == "buckets_alone":
        probe = None
    elif bad == "probe_1d":
        probe = probe.reshape(-1)
    elif bad == "buckets_1d":
        buckets = buckets.reshape(-1)
    elif bad == "zero_probes":
        probe = torch.zeros((2, 0), dtype=torch.int32)
    elif bad == "empty_table":
        buckets = torch.zeros((0, 3), dtype=torch.int32)
    elif bad == "buckets_noncontig":
        buckets = torch.zeros((3, 4), dtype=torch.int32).T
    else:
        probe = torch.zeros((2, 2), dtype=torch.int32).T
    before = dict(kivf.launches)
    with pytest.raises(ValueError):
        ops.ivf_topk(q, keys, cand, k=4, probe=probe, buckets=buckets)
    with pytest.raises(ValueError):
        kivf.ivf_topk_cuda(q, keys, cand, 4, probe=probe, buckets=buckets)
    assert kivf.launches == before


def test_search_hands_the_grouping_to_the_kernel(monkeypatch):
    """``IVFIndex.search`` passes its probe (int32) and bucket table to
    ``ops.ivf_topk``, and they keep the contract."""
    _, tidx, _, tst, keys, q, valid, _ = _index_inputs("shared")
    seen = {}
    original = ops.ivf_topk

    def spy(queries, keys, cand, **kw):
        seen.update(kw, cand=cand)
        return original(queries, keys, cand, **kw)
    monkeypatch.setattr(ops, "ivf_topk", spy)
    tidx.search(tst, torch.from_numpy(q), torch.from_numpy(keys),
                torch.from_numpy(valid))
    assert seen["probe"].dtype == torch.int32
    assert seen["probe"].shape == (9, min(tidx.nprobe, tidx.ncentroids))
    assert torch.equal(seen["buckets"], tst.buckets)
    kivf.check_contract(seen["cand"], seen["probe"], seen["buckets"])
    assert seen["backend"] == tidx.backend
