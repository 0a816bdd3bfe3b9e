"""The public names the port added to match the reference's exports,
against the JAX package: ``core.similarity.cosine_similarity`` and
``best_match``, ``CacheState.capacity`` / ``.dim``,
``CacheStats.hit_rate`` and ``training.load_checkpoint(path, template)``
on snapshots written by either package. Inputs come from numpy; floats
within 1e-6, everything else exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CacheConfig as JCacheConfig
from repro.core import SemanticCache as JSemanticCache
from repro.core.similarity import best_match as jbest_match
from repro.core.similarity import cosine_similarity as jcosine_similarity
from repro.core.types import CacheStats as JCacheStats
from repro.core.types import init_cache_state as jinit_cache_state
from repro.training import load_checkpoint as jload_checkpoint
from repro.training import save_checkpoint as jsave_checkpoint
from repro_torch.core import CacheConfig, SemanticCache
from repro_torch.core.similarity import best_match, cosine_similarity
from repro_torch.core.types import CacheStats, init_cache_state
from repro_torch.training import (CheckpointCorruptError, load_checkpoint,
                                  save_checkpoint)
from repro_torch.training.checkpoint import runtime_to_numpy

TOL = 1e-6


def test_cosine_similarity_matches_jax():
    rng = np.random.default_rng(0)
    u = rng.standard_normal((5, 7, 16)).astype(np.float32)
    v = rng.standard_normal((5, 7, 16)).astype(np.float32)
    u[0, 0] = 0.0                       # a zero vector: eps, not NaN
    got = cosine_similarity(torch.from_numpy(u), torch.from_numpy(v))
    want = np.asarray(jcosine_similarity(jnp.asarray(u), jnp.asarray(v)))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert float(got[0, 0]) == 0.0


def test_best_match_matches_jax_with_ties():
    rng = np.random.default_rng(1)
    scores = rng.standard_normal((6, 40)).astype(np.float32)
    scores[1, [3, 17, 30]] = 5.0        # tied maxima: the first wins
    scores[2] = -np.inf                 # nothing visible
    idx, val = best_match(torch.from_numpy(scores))
    jidx, jval = jbest_match(jnp.asarray(scores))
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(val.numpy(), np.asarray(jval))
    assert int(idx[1]) == 3


@pytest.mark.parametrize("capacity,dim", [(64, 16), (512, 384)])
def test_cache_state_capacity_and_dim_match_jax(capacity, dim):
    st = init_cache_state(CacheConfig(dim=dim, capacity=capacity), "cpu")
    jst = jinit_cache_state(JCacheConfig(dim=dim, capacity=capacity))
    assert (st.capacity, st.dim) == (jst.capacity, jst.dim) == (capacity,
                                                                dim)


@pytest.mark.parametrize("lookups,hits", [(0, 0), (7, 3), (1000, 1000)])
def test_cache_stats_hit_rate_matches_jax(lookups, hits):
    def ints(cls, mod):
        return cls(**{n: mod.asarray(x, dtype=mod.int32) for n, x in (
            ("lookups", lookups), ("hits", hits),
            ("misses", lookups - hits), ("expired_evictions", 0),
            ("inserts", 0))})
    got = ints(CacheStats, torch).hit_rate()
    want = np.asarray(ints(JCacheStats, jnp).hit_rate())
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def _filled():
    """The same traffic through both packages' caches: their runtimes."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((12, 16)).astype(np.float32)
    vals = rng.integers(0, 50, (12, 4)).astype(np.int32)
    lens = np.full((12,), 4, dtype=np.int32)
    cache = SemanticCache(CacheConfig(dim=16, capacity=64, value_len=4,
                                      ttl=None))
    rt = cache.insert(cache.init("cpu"), torch.from_numpy(q),
                      torch.from_numpy(vals), torch.from_numpy(lens), 1.0)
    _, rt = cache.lookup(rt, torch.from_numpy(q[:5]), 2.0)
    jcache = JSemanticCache(JCacheConfig(dim=16, capacity=64, value_len=4,
                                         ttl=None))
    jrt = jcache.insert(jcache.init(), jnp.asarray(q), jnp.asarray(vals),
                        jnp.asarray(lens), jnp.float32(1.0))
    _, jrt = jcache.lookup(jrt, jnp.asarray(q[:5]), jnp.float32(2.0))
    return cache, rt, jcache, jrt


def test_load_checkpoint_reads_a_jax_snapshot_into_a_template(tmp_path):
    cache, rt, jcache, jrt = _filled()
    jsave_checkpoint(str(tmp_path / "jax"), {"runtime": jrt})
    got = load_checkpoint(str(tmp_path / "jax"),
                          {"runtime": cache.init("cpu")})["runtime"]
    assert type(got) is type(rt)
    mine = runtime_to_numpy(rt)
    for key, arr in runtime_to_numpy(got).items():
        assert arr.dtype == mine[key].dtype, key
        if arr.dtype.kind == "f":
            np.testing.assert_allclose(arr, mine[key], rtol=0, atol=TOL,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(arr, mine[key], err_msg=key)


def test_jax_load_checkpoint_reads_a_port_snapshot(tmp_path):
    cache, rt, jcache, jrt = _filled()
    save_checkpoint(str(tmp_path / "port"), runtime_to_numpy(rt))
    got = jload_checkpoint(str(tmp_path / "port"),
                           {"runtime": jcache.init()})["runtime"]
    back = load_checkpoint(str(tmp_path / "port"),
                           {"runtime": cache.init("cpu")})["runtime"]
    for name in ("keys", "values", "valid", "source_id", "n_inserts"):
        np.testing.assert_array_equal(np.asarray(getattr(got.state, name)),
                                      getattr(back.state, name).numpy(),
                                      err_msg=name)
        np.testing.assert_array_equal(getattr(back.state, name).numpy(),
                                      getattr(rt.state, name).numpy(),
                                      err_msg=name)


def test_load_checkpoint_refuses_a_template_it_cannot_fill(tmp_path):
    cache, rt, _, _ = _filled()
    save_checkpoint(str(tmp_path / "port"), runtime_to_numpy(rt))
    with pytest.raises(CheckpointCorruptError, match="missing key"):
        load_checkpoint(str(tmp_path / "port"),
                        {"other": cache.init("cpu")})
    big = SemanticCache(CacheConfig(dim=16, capacity=128, value_len=4))
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(str(tmp_path / "port"),
                        {"runtime": big.init("cpu")})
