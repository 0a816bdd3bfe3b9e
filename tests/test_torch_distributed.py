"""The port's sharded cache (``repro_torch.core.distributed``) against the
JAX package's ``DistributedCache`` and against the local step, on the CPU.

The JAX side runs once, in ONE subprocess with 8 forced host devices (as
``tests/test_distributed.py::run_with_devices`` does), from the
module-scoped ``jax_side`` fixture: it replays the traffic of the JAX
package's distributed tests on numpy-seeded inputs, drives the
full-feature parity harness of ``tests/test_sharded_parity.py`` through the
JAX *local* step (the JAX sharded harness itself fails under this jax),
reshards the port's snapshots with the JAX ``reshard_runtime``, and swaps
engine snapshots with the port; every result lands in one npz.

Tolerances: slab floats port vs JAX within 1e-7 (as
``test_torch_store_cache``), lookup scores within 1e-5, fused slab keys
port vs JAX within 1e-6; everything else exactly, and the port's sharded
keys bit for bit against its local step's.
"""
import asyncio
import dataclasses
import inspect
import json
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from repro_torch.context.fusion import (AttentionFusion, DecayMeanFusion,
                                        FusionState)
from repro_torch.core import (CacheConfig, DistributedCache, SemanticCache,
                              make_mesh, shard_axes)
from repro_torch.core.index import ExactIndex, IVFIndex
from repro_torch.data.qa_dataset import build_corpus, build_test_queries
from repro_torch.generative.policy import BandPolicy
from repro_torch.serving import (AsyncCacheServer, CachedEngine, Request,
                                 SchedulerConfig, SimulatedLLMBackend,
                                 run_waves)
from repro_torch.tenancy.registry import TenantRegistry, TenantSpec
from repro_torch.training import checkpoint

REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
FLOAT_TOL = 1e-7
SCORE_TOL = 1e-5
KEY_TOL = 1e-6
STATE = ("keys", "values", "value_lens", "expiry", "valid", "freq",
         "last_used", "inserted_at", "source_id", "ptr", "n_inserts")
STATS = ("lookups", "hits", "misses", "expired_evictions", "inserts")
TENANCY = ("ptr", "lookups", "hits", "inserts", "evictions")
RESHARD = [(1, 4), (4, 1), (4, 2)]
PARITY_ROUNDS, PB, PD, PW = 6, 16, 32, 3
IVF = dict(ncentroids=4, nprobe=4, bucket_cap=256, topk=4, kmeans_iters=2)


# a mesh given both ways: one device for every shard, or a list of one
# device a shard (``jax.make_mesh(..., devices=)``; here all the CPU)
MESH_AS = ["one_device", "device_list"]


def cpu_mesh(*shape, names=("data",), mesh_as="one_device"):
    n = int(np.prod(shape))
    return make_mesh(shape, names, device="cpu" if mesh_as == "one_device"
                     else ["cpu"] * n)


def assert_close(got, want, name, tol=FLOAT_TOL):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


# --------------------------------------------------------------------- #
# inputs shared by both packages (numpy, seeded)
def traffic_inputs() -> dict:
    rng = np.random.default_rng(11)
    f32 = np.float32
    return {
        # test_lookup_insert_across_shards: (4, 2) mesh, 4 shards
        "A/q": rng.standard_normal((16, 32)).astype(f32),
        "A/qq": rng.standard_normal((3, 6, 32)).astype(f32),
        # test_ttl_respected_across_shards: (4,) mesh
        "B/q": rng.standard_normal((8, 16)).astype(f32),
        # test_distributed_matches_local_lookup
        "C/emb": rng.standard_normal((32, 48)).astype(f32),
        "C/vals": rng.integers(0, 99, (32, 6)).astype(np.int32),
        "C/noise": rng.standard_normal((16, 48)).astype(f32),
    }


def reshard_config():
    return CacheConfig(dim=16, capacity=128, value_len=4, ttl=None)


def reshard_partition():
    return TenantRegistry.uniform(("a", "b")).partition(128)


def reshard_flats() -> dict:
    """Flattened port runtimes after masked, tenant-mixed traffic that
    wraps a ring: unsharded and 4-shard, without and with a partition."""
    out = {}
    for shards in (1, 4):
        for part in (None, reshard_partition()):
            cfg, rng = reshard_config(), np.random.default_rng(3)
            cache = SemanticCache(cfg, partition=part)
            if shards > 1:
                cache = DistributedCache(cache, cpu_mesh(shards))
            rt = cache.init("cpu")
            for b in range(9):
                q = torch.from_numpy(rng.standard_normal((16, 16)).astype(
                    np.float32))
                mask = torch.from_numpy(rng.random(16) < 0.8)
                tid = torch.from_numpy(rng.integers(0, 2, 16).astype(
                    np.int32)) if part is not None else None
                vals = torch.from_numpy(rng.integers(0, 50, (16, 4)).astype(
                    np.int32))
                rt = cache.insert(rt, q, vals, torch.full((16,), 4,
                                                          dtype=torch.int32),
                                  float(b), source_id=torch.arange(
                                      16, dtype=torch.int32) + 16 * b,
                                  mask=mask, tenant_id=tid)
                _, rt = cache.lookup(rt, q[:8] + 0.01, float(b) + 0.5,
                                     tenant_id=None if tid is None
                                     else tid[:8])
            out[(shards, part is not None)] = checkpoint.runtime_to_numpy(rt)
    return out


def engine_pairs():
    return build_corpus(20, seed=0)


def engine_requests(pairs, seed):
    qs = build_test_queries(pairs, n_per_category=4, seed=seed)
    return [Request(query=q.query, category=q.category,
                    source_id=q.source_id,
                    tenant=("acme", "zen")[i % 2]) for i, q in enumerate(qs)]


def make_engine(mesh=None, **kw):
    pairs = engine_pairs()
    cfg = CacheConfig(dim=384, capacity=512, value_len=48, ttl=None,
                      threshold=0.8)
    return CachedEngine(cfg, SimulatedLLMBackend(pairs), batch_size=8,
                        registry=TenantRegistry.uniform(("acme", "zen")),
                        mesh=mesh, device="cpu", **kw)


def warmed_engine(mesh=None, **kw):
    eng = make_engine(mesh, **kw)
    pairs = engine_pairs()
    eng.warm(pairs[:40], tenant="acme")
    eng.warm(pairs[40:], tenant="zen")
    return eng


def responses_of(resp) -> dict:
    return {"cached": np.array([r.cached for r in resp]),
            "answer": np.array([r.answer for r in resp]),
            "score": np.array([r.score for r in resp], dtype=np.float64)}


def same_responses(got: dict, want: dict, where: str) -> None:
    np.testing.assert_array_equal(got["cached"], want["cached"],
                                  err_msg=where)
    np.testing.assert_array_equal(got["answer"], want["answer"],
                                  err_msg=where)
    np.testing.assert_allclose(got["score"], want["score"], rtol=0,
                               atol=SCORE_TOL, err_msg=where)


JAX_SCRIPT = r'''
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import SemanticCache, CacheConfig, DistributedCache
from repro.core.index import IVFIndex
from repro.context.fusion import DecayMeanFusion
from repro.data.qa_dataset import build_corpus, build_test_queries
from repro.generative.policy import BandPolicy
from repro.serving import CachedEngine, Request, SimulatedLLMBackend
from repro.tenancy.registry import TenantRegistry, TenantSpec
from repro.training.checkpoint import (_flatten, open_checkpoint,
                                       reshard_runtime)

d = sys.argv[1]
inp = dict(np.load(d + "/inputs.npz"))
out = {}
STATE = %(state)r
STATS = %(stats)r

def keep(prefix, rt):
    for n in STATE:
        out[f"{prefix}/state/{n}"] = np.asarray(getattr(rt.state, n))
    for n in STATS:
        out[f"{prefix}/stats/{n}"] = np.asarray(getattr(rt.stats, n))

def keep_step(prefix, res):
    for n, x in zip(("slot", "score", "hit", "values", "value_lens",
                     "source_id"), res):
        out[f"{prefix}/{n}"] = np.asarray(x)

# -- traffic A: test_lookup_insert_across_shards ------------------------
mesh = jax.make_mesh((4, 2), ("data", "model"))
cfg = CacheConfig(dim=32, capacity=256, value_len=8, ttl=1e9)
dc = DistributedCache(SemanticCache(cfg), mesh)
rt, step = dc.init(), dc.make_lookup_insert()
q = jnp.asarray(inp["A/q"])
vals = jnp.arange(16 * 8, dtype=jnp.int32).reshape(16, 8)
vlens = jnp.full((16,), 8, jnp.int32)
sid = jnp.arange(16, dtype=jnp.int32)
rt, res = step(rt, q, vals, vlens, sid, jnp.float32(0.0))
keep_step("A/s0", res)
rt, res = step(rt, q + 0.01, vals, vlens, sid, jnp.float32(1.0))
keep_step("A/s1", res)
for rep in range(3):
    rt, res = step(rt, jnp.asarray(inp["A/qq"][rep]), vals[:6], vlens[:6],
                   sid[:6], jnp.float32(2.0 + rep))
    keep_step(f"A/r{rep}", res)
rt, res = step(rt, jnp.asarray(inp["A/qq"][0]) + 0.01, vals[:6], vlens[:6],
               sid[:6], jnp.float32(9.0))
keep_step("A/s9", res)
keep("A", rt)

# -- traffic B: test_ttl_respected_across_shards -------------------------
dc = DistributedCache(SemanticCache(CacheConfig(dim=16, capacity=64,
                                                value_len=4, ttl=10.0)),
                      jax.make_mesh((4,), ("data",)))
rt, step = dc.init(), dc.make_lookup_insert()
q = jnp.asarray(inp["B/q"])
vals = jnp.zeros((8, 4), jnp.int32); vl = jnp.full((8,), 4, jnp.int32)
sid = jnp.arange(8, dtype=jnp.int32)
for t in (0.0, 5.0, 20.0):
    rt, res = step(rt, q, vals, vl, sid, jnp.float32(t))
    keep_step(f"B/t{int(t)}", res)
keep("B", rt)

# -- traffic C: test_distributed_matches_local_lookup ---------------------
cfg = CacheConfig(dim=48, capacity=128, value_len=6, ttl=None, threshold=0.8)
dc = DistributedCache(SemanticCache(cfg), mesh)
rt, step = dc.init(), dc.make_lookup_insert()
emb, cvals = jnp.asarray(inp["C/emb"]), jnp.asarray(inp["C/vals"])
lens = jnp.full((32,), 6, jnp.int32)
queries = emb[:16] + 0.02 * jnp.asarray(inp["C/noise"])
rt, res = step(rt, emb, cvals, lens, jnp.arange(32, dtype=jnp.int32),
               jnp.float32(0.0)); keep_step("C/s0", res)
rt, res = step(rt, queries, jnp.zeros((16, 6), jnp.int32),
               jnp.zeros((16,), jnp.int32), jnp.full((16,), -1, jnp.int32),
               jnp.float32(1.0)); keep_step("C/s1", res)
keep("C", rt)

# -- the parity harness through the JAX local step -------------------------
for name, index in (("exact", None),
                    ("ivf", IVFIndex(backend="jnp", **%(ivf)r))):
    cfg = CacheConfig(dim=32, capacity=256, value_len=8, ttl=None,
                      threshold=0.8, topk=4)
    reg = TenantRegistry((TenantSpec(name="acme"),
                          TenantSpec(name="zen", threshold=0.85,
                                     band_lo=0.65)))
    local = SemanticCache(cfg, policy=BandPolicy(tau_lo=0.70, tau_hi=0.80),
                          partition=reg.partition(cfg.capacity),
                          fusion=DecayMeanFusion(window=3), index=index)
    lrt = local.init()
    lstep = jax.jit(lambda rt, q, mv, mvl, t, sid, valid, tid, w, wl:
                    local.step(rt, q, mv, mvl, t, source_id=sid,
                               valid=valid, tenant_id=tid, window=w,
                               window_len=wl))
    B, D, W = %(pb)d, %(pd)d, %(pw)d
    rng = np.random.default_rng(7)
    inserted = []
    for r in range(%(rounds)d):
        fresh = rng.standard_normal((B, D)).astype(np.float32)
        q = fresh.copy()
        if inserted:
            pool = np.concatenate(inserted)
            pick = rng.integers(0, len(pool), size=B // 2)
            q[: B // 2] = pool[pick] + \
                0.05 * rng.standard_normal((B // 2, D)).astype(np.float32)
        mv = rng.integers(0, 99, size=(B, 8)).astype(np.int32)
        mvl = np.full((B,), 8, dtype=np.int32)
        sid = np.arange(r * B, (r + 1) * B, dtype=np.int32)
        valid = np.ones((B,), dtype=bool)
        valid[-2:] = r %% 2 == 0
        tid = rng.integers(0, 2, size=B).astype(np.int32)
        w = rng.standard_normal((B, W, D)).astype(np.float32)
        wl = rng.integers(0, W + 1, size=B).astype(np.int32)
        p = f"P/{name}/r{r}"
        for k, v in (("q", q), ("mv", mv), ("mvl", mvl), ("sid", sid),
                     ("valid", valid), ("tid", tid), ("w", w), ("wl", wl)):
            out[f"{p}/in/{k}"] = v
        args = [jnp.asarray(a) for a in
                (q, mv, mvl, np.float32(r), sid, valid, tid, w, wl)]
        res, lrt = lstep(lrt, *args)
        hit = np.asarray(res.hit)
        for k in ("hit", "near", "score", "values", "source_id"):
            out[f"{p}/{k}"] = np.asarray(getattr(res, k))
        pay = local.gather_topk(lrt, res)
        out[f"{p}/topk_source"] = np.sort(np.asarray(pay["source_id"]), 1)
        inserted.append(q[~hit & valid])
    for k in STATS:
        out[f"P/{name}/stats/{k}"] = np.asarray(getattr(lrt.stats, k))
    for k in ("lookups", "hits", "inserts", "evictions"):
        out[f"P/{name}/tenancy/{k}"] = np.asarray(getattr(lrt.tenancy, k))
    v = np.asarray(lrt.state.valid)
    out[f"P/{name}/keys"] = np.asarray(lrt.state.keys)[v]
    out[f"P/{name}/key_source"] = np.asarray(lrt.state.source_id)[v]

# -- reshard_runtime on the port's flattened runtimes ----------------------
cfg = CacheConfig(dim=16, capacity=128, value_len=4, ttl=None)
part = TenantRegistry.uniform(("a", "b")).partition(128)
for old, new in %(reshard)r:
    for tag, p in (("plain", None), ("part", part)):
        flat = open_checkpoint(f"{d}/flat_{old}_{tag}")
        cache = SemanticCache(cfg, partition=p)
        if new > 1:
            template = DistributedCache(
                cache, jax.make_mesh((new,), ("data",))).init()
        else:
            template = cache.init()
        got = reshard_runtime(flat, template, old_shards=old,
                              new_shards=new, partition=p)
        for k, x in _flatten({"runtime": got}).items():
            out[f"R/{old}_{new}_{tag}/{k}"] = x

# -- engine snapshots across the packages ---------------------------------
pairs = build_corpus(20, seed=0)
def reqs(seed):
    qs = build_test_queries(pairs, n_per_category=4, seed=seed)
    return [Request(query=q.query, category=q.category,
                    source_id=q.source_id, tenant=("acme", "zen")[i %% 2])
            for i, q in enumerate(qs)]
def engine():
    cfg = CacheConfig(dim=384, capacity=512, value_len=48, ttl=None,
                      threshold=0.8)
    return CachedEngine(cfg, SimulatedLLMBackend(pairs), batch_size=8,
                        registry=TenantRegistry.uniform(("acme", "zen")),
                        mesh=jax.make_mesh((4,), ("data",)))
def keep_resp(prefix, resp):
    out[prefix + "/cached"] = np.array([r.cached for r in resp])
    out[prefix + "/answer"] = np.array([r.answer for r in resp])
    out[prefix + "/score"] = np.array([r.score for r in resp])
je = engine()
je.warm(pairs[:40], tenant="acme"); je.warm(pairs[40:], tenant="zen")
je.process(reqs(3))
je.save_cache(d + "/jax4")
# served by a fresh engine restored from the snapshot: a restored engine's
# tokenizer has seen none of the cached answers' words
jr = engine()
jr.load_cache(d + "/jax4", reshard=False)
keep_resp("E/jax4", jr.process(reqs(4)))
out["E/jax4/tenant_stats"] = np.array(json.dumps(jr.tenant_stats()))
for mesh_as in %(mesh_as)r:
    jp = engine()
    jp.load_cache(f"{d}/port4_{mesh_as}", reshard=False)
    keep_resp(f"E/port4_in_jax/{mesh_as}", jp.process(reqs(4)))
    out[f"E/port4_in_jax/{mesh_as}/tenant_stats"] = np.array(
        json.dumps(jp.tenant_stats()))
np.savez(d + "/jax.npz", **out)
print("JAX-SIDE-OK")
''' % dict(state=STATE, stats=STATS, ivf=IVF, pb=PB, pd=PD, pw=PW,
           rounds=PARITY_ROUNDS, reshard=RESHARD, mesh_as=MESH_AS)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """Writes the inputs and the port's snapshots, runs the JAX side once
    and returns its npz, the directory and the port engine's follow-up
    responses."""
    d = tmp_path_factory.mktemp("jax_side")
    np.savez(d / "inputs.npz", **traffic_inputs())
    for (shards, part), flat in reshard_flats().items():
        checkpoint.save_checkpoint(
            str(d / f"flat_{shards}_{'part' if part else 'plain'}"), flat)
    port_follow, port_stats = {}, {}
    for mesh_as in MESH_AS:
        port = warmed_engine(cpu_mesh(4, mesh_as=mesh_as))
        port.process(engine_requests(engine_pairs(), 3))
        port.save_cache(str(d / f"port4_{mesh_as}"))
        # a fresh engine restored from the snapshot serves the follow-ups,
        # as the JAX engine that restores it does (a restored engine's
        # tokenizer has seen none of the cached answers' words)
        port = make_engine(cpu_mesh(4, mesh_as=mesh_as))
        port.load_cache(str(d / f"port4_{mesh_as}"), reshard=False)
        port_follow[mesh_as] = responses_of(port.process(
            engine_requests(engine_pairs(), 4)))
        port_stats[mesh_as] = port.tenant_stats()
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = REPO_SRC
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_SCRIPT),
                        str(d)], capture_output=True, text=True,
                       timeout=600, env=env)
    assert r.returncode == 0 and "JAX-SIDE-OK" in r.stdout, \
        f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return {"out": dict(np.load(d / "jax.npz")), "dir": d,
            "port_follow": port_follow, "port_stats": port_stats}


# --------------------------------------------------------------------- #
# the comm seams
def run_shards(s: int, body):
    """``body(comm)`` on each of ``s`` shards through the real SPMD runner;
    returns the shards' results in shard order."""
    dc = DistributedCache(SemanticCache(CacheConfig(dim=4, capacity=8 * s)),
                          cpu_mesh(s))
    firsts, _, _ = dc._spmd(dc.init(), lambda rt, comm: (body(comm), rt))
    return firsts


def seam_merge_ties():
    # every shard offers the same scores: ties break to the lowest global
    # slot, whatever order the shards arrive in
    top_s = torch.tensor([[0.9, 0.5, float("-inf")]])
    top_i = torch.tensor([[3, 1, -1]], dtype=torch.int32)
    out = run_shards(4, lambda c: c.merge_topk(top_s, top_i))
    for s, i in out:
        assert torch.equal(s, torch.full((1, 3), 0.9))
        assert i.tolist() == [[3, 11, 19]]         # shards 0, 1, 2
    # a row with nothing visible anywhere stays (-inf, -1)
    out = run_shards(2, lambda c: c.merge_topk(
        torch.full((1, 2), float("-inf")),
        torch.full((1, 2), -1, dtype=torch.int32)))
    assert out[0][1].tolist() == [[-1, -1]]


def seam_fetch_owner():
    def body(c):
        st = SemanticCache(CacheConfig(dim=4, capacity=8, value_len=2)
                           ).init("cpu").state
        st.values[:] = 100 * c.shard + torch.arange(8)[:, None]
        st.value_lens[:] = c.shard + 1
        st.source_id[:] = 10 * c.shard + torch.arange(8)
        return c.fetch_best(st, torch.tensor([5, 8 + 2, 24 + 7, -1]))
    for vals, lens, src in run_shards(4, body):
        assert vals[:, 0].tolist() == [5, 102, 307, 0]
        assert lens.tolist() == [1, 2, 4, 0]
        assert src.tolist() == [5, 12, 37, 0]


def seam_touch_owner():
    def body(c):
        st = SemanticCache(CacheConfig(dim=4, capacity=8)).init("cpu").state
        c.touch(st, torch.tensor([3, 8 + 3, 8 + 4]), 5.0,
                torch.tensor([True, True, False]))
        return st.freq.clone()
    freq = run_shards(2, body)
    assert freq[0].tolist() == [0, 0, 0, 1, 0, 0, 0, 0]
    assert freq[1].tolist() == [0, 0, 0, 1, 0, 0, 0, 0]


def seam_primary():
    counts = torch.tensor([1, 2, 3], dtype=torch.int32)
    out = run_shards(3, lambda c: c.primary(counts))
    assert [o.tolist() for o in out] == [[1, 2, 3], [0, 0, 0], [0, 0, 0]]


def seam_prepare_fill():
    # after n round-robin inserts shard s holds ceil((n - s) / S) entries
    def body(c):
        st = SemanticCache(CacheConfig(dim=4, capacity=8)).init("cpu").state
        return [int(c.prepare_insert(dataclasses.replace(
            st, n_inserts=torch.tensor(n, dtype=torch.int32))).ptr)
            for n in (0, 1, 5, 6, 7, 33)]
    out = run_shards(4, body)
    want = [[max(0, -(-(n - s) // 4)) % 8 for n in (0, 1, 5, 6, 7, 33)]
            for s in range(4)]
    assert out == want


@pytest.mark.parametrize("seam", [seam_merge_ties, seam_fetch_owner,
                                  seam_touch_owner, seam_primary,
                                  seam_prepare_fill],
                         ids=lambda f: f.__name__[5:])
def test_comm_seams(seam):
    seam()


def test_round_robin_balance_under_masked_inserts():
    """Rows 0, 4, 8 and 12 of each 16-row batch masked in, 8 batches on 4
    shards: routing by the rank among masked-in rows keeps every shard at
    8 entries (routing by row index would put all 32 on one)."""
    cfg = CacheConfig(dim=16, capacity=128, value_len=4, ttl=None)
    dc = DistributedCache(SemanticCache(cfg), cpu_mesh(4))
    rt = dc.init()
    mask = torch.zeros((16,), dtype=torch.bool)
    mask[::4] = True
    rng = np.random.default_rng(0)
    for b in range(8):
        q = torch.from_numpy(rng.standard_normal((16, 16)).astype(np.float32))
        rt = dc.insert(rt, q, torch.zeros((16, 4), dtype=torch.int32),
                       torch.full((16,), 4, dtype=torch.int32), float(b),
                       mask=mask)
    assert int(rt.state.n_inserts) == 32
    assert rt.state.valid.reshape(4, -1).sum(1).tolist() == [8, 8, 8, 8]


# --------------------------------------------------------------------- #
# the global slab against the JAX DistributedCache
def _slab_equal(rt, out, prefix):
    for n in STATE:
        assert_close(getattr(rt.state, n), out[f"{prefix}/state/{n}"],
                     f"{prefix} state.{n}")
    for n in STATS:
        assert_close(getattr(rt.stats, n), out[f"{prefix}/stats/{n}"],
                     f"{prefix} stats.{n}")


def _step_equal(res, out, prefix):
    for n, x in zip(("slot", "score", "hit", "values", "value_lens",
                     "source_id"), res):
        assert_close(x, out[f"{prefix}/{n}"], f"{prefix} {n}",
                     tol=SCORE_TOL)


def traffic_a(out, inp, mesh_as):
    dc = DistributedCache(SemanticCache(CacheConfig(
        dim=32, capacity=256, value_len=8, ttl=1e9)),
        cpu_mesh(4, 2, names=("data", "model"), mesh_as=mesh_as))
    assert dc.num_shards == 4
    rt, step = dc.init(), dc.make_lookup_insert()
    q = torch.from_numpy(inp["A/q"])
    vals = torch.arange(16 * 8, dtype=torch.int32).reshape(16, 8)
    vlens = torch.full((16,), 8, dtype=torch.int32)
    sid = torch.arange(16, dtype=torch.int32)
    rt, res = step(rt, q, vals, vlens, sid, 0.0)
    _step_equal(res, out, "A/s0")
    rt, res = step(rt, q + 0.01, vals, vlens, sid, 1.0)
    _step_equal(res, out, "A/s1")
    assert int(res[2].sum()) == 16
    for rep in range(3):
        rt, res = step(rt, torch.from_numpy(inp["A/qq"][rep]), vals[:6],
                       vlens[:6], sid[:6], 2.0 + rep)
        _step_equal(res, out, f"A/r{rep}")
    rt, res = step(rt, torch.from_numpy(inp["A/qq"][0]) + 0.01, vals[:6],
                   vlens[:6], sid[:6], 9.0)
    _step_equal(res, out, "A/s9")
    assert int(res[2].sum()) == 6
    return rt


def traffic_b(out, inp, mesh_as):
    dc = DistributedCache(SemanticCache(CacheConfig(
        dim=16, capacity=64, value_len=4, ttl=10.0)),
        cpu_mesh(4, mesh_as=mesh_as))
    rt, step = dc.init(), dc.make_lookup_insert()
    q = torch.from_numpy(inp["B/q"])
    for t, hits in ((0, 0), (5, 8), (20, 0)):      # expired everywhere at 20
        rt, res = step(rt, q, torch.zeros((8, 4), dtype=torch.int32),
                       torch.full((8,), 4, dtype=torch.int32),
                       torch.arange(8, dtype=torch.int32), float(t))
        _step_equal(res, out, f"B/t{t}")
        assert int(res[2].sum()) == hits
    return rt


def traffic_c(out, inp, mesh_as):
    cfg = CacheConfig(dim=48, capacity=128, value_len=6, ttl=None,
                      threshold=0.8)
    dc = DistributedCache(SemanticCache(cfg),
                          cpu_mesh(4, 2, names=("data", "model"),
                                   mesh_as=mesh_as))
    rt, step = dc.init(), dc.make_lookup_insert()
    emb = torch.from_numpy(inp["C/emb"])
    vals = torch.from_numpy(inp["C/vals"])
    queries = emb[:16] + 0.02 * torch.from_numpy(inp["C/noise"])
    rt, res = step(rt, emb, vals, torch.full((32,), 6, dtype=torch.int32),
                   torch.arange(32, dtype=torch.int32), 0.0)
    _step_equal(res, out, "C/s0")
    rt, res = step(rt, queries, torch.zeros((16, 6), dtype=torch.int32),
                   torch.zeros((16,), dtype=torch.int32),
                   torch.full((16,), -1, dtype=torch.int32), 1.0)
    _step_equal(res, out, "C/s1")
    # the local cache over the same contents decides the same
    local = SemanticCache(cfg)
    lrt = local.insert(local.init("cpu"), emb, vals,
                       torch.full((32,), 6, dtype=torch.int32), 0.0)
    lres, _ = local.lookup(lrt, queries, 1.0)
    assert torch.equal(res[2], lres.hit)
    assert torch.equal(res[3][lres.hit], lres.values[lres.hit])
    return rt


@pytest.mark.parametrize("mesh_as", MESH_AS)
@pytest.mark.parametrize("traffic", [traffic_a, traffic_b, traffic_c],
                         ids=["lookup_insert", "ttl", "matches_local"])
def test_global_slab_equals_jax_distributed_cache(jax_side, traffic,
                                                  mesh_as):
    prefix = traffic.__name__[-1].upper()
    rt = traffic(jax_side["out"], traffic_inputs(), mesh_as)
    _slab_equal(rt, jax_side["out"], prefix)


# --------------------------------------------------------------------- #
# full-feature parity: two tenants, band, fusion, pad rows; exact and IVF
def parity_cache(index_name):
    cfg = CacheConfig(dim=PD, capacity=256, value_len=8, ttl=None,
                      threshold=0.8, topk=4)
    reg = TenantRegistry((TenantSpec(name="acme"),
                          TenantSpec(name="zen", threshold=0.85,
                                     band_lo=0.65)))
    return SemanticCache(
        cfg, policy=BandPolicy(tau_lo=0.70, tau_hi=0.80),
        partition=reg.partition(cfg.capacity),
        fusion=DecayMeanFusion(window=PW),
        index=None if index_name == "exact" else IVFIndex(**IVF))


def parity_round(out, name, r):
    p = f"P/{name}/r{r}"
    t = {k: torch.from_numpy(out[f"{p}/in/{k}"]) for k in
         ("q", "mv", "mvl", "sid", "valid", "tid", "w", "wl")}
    return p, t


def run_parity(cache, rt, out, name):
    results = []
    for r in range(PARITY_ROUNDS):
        _, t = parity_round(out, name, r)
        res, rt = cache.step(rt, t["q"], t["mv"], t["mvl"], float(r),
                             source_id=t["sid"], valid=t["valid"],
                             tenant_id=t["tid"], window=t["w"],
                             window_len=t["wl"])
        results.append((res, cache.gather_topk(rt, res)))
    return rt, results


@pytest.mark.parametrize("mesh_as", MESH_AS)
@pytest.mark.parametrize("index_name", ["exact", "ivf"])
def test_full_feature_parity_against_local_steps(jax_side, index_name,
                                                 mesh_as):
    """The port's 4-shard cache against the port's local step and the JAX
    package's local step on the parity harness of
    ``tests/test_sharded_parity.py``: hit, near, scores, served values and
    provenance, top-k provenance sets, stats, reduced tenancy counters and
    the slab's key multiset."""
    out = jax_side["out"]
    local = parity_cache(index_name)
    dc = DistributedCache(parity_cache(index_name),
                          cpu_mesh(4, mesh_as=mesh_as))
    lrt, lres = run_parity(local, local.init("cpu"), out, index_name)
    drt, dres = run_parity(dc, dc.init(), out, index_name)
    for r, ((lr, lpay), (dr, dpay)) in enumerate(zip(lres, dres)):
        p, _ = parity_round(out, index_name, r)
        hit = torch.from_numpy(out[f"{p}/hit"])
        for res, where in ((lr, "local"), (dr, "sharded")):
            msg = f"{where} round {r}"
            assert torch.equal(res.hit, hit), msg
            assert torch.equal(res.near, torch.from_numpy(out[f"{p}/near"])
                               ), msg
            assert_close(res.score, out[f"{p}/score"], msg, tol=SCORE_TOL)
            assert_close(res.values[hit], out[f"{p}/values"][hit.numpy()],
                         msg)
            assert_close(res.source_id[hit],
                         out[f"{p}/source_id"][hit.numpy()], msg)
        assert_close(torch.sort(dpay["source_id"], 1).values,
                     out[f"{p}/topk_source"], f"top-k, round {r}")
        assert torch.equal(torch.sort(lpay["source_id"], 1).values,
                           torch.sort(dpay["source_id"], 1).values)
    # the harness reaches hits and band rows, not only misses
    assert sum(int(r.hit.sum()) for r, _ in dres) > 0
    assert sum(int(r.near.sum()) for r, _ in dres) > 0
    for n in STATS:
        want = out[f"P/{index_name}/stats/{n}"]
        assert_close(getattr(drt.stats, n), want, n)
        assert_close(getattr(lrt.stats, n), want, n)
    red = drt.tenancy.reduced()
    for n in ("lookups", "hits", "inserts", "evictions"):
        assert_close(getattr(red, n), out[f"P/{index_name}/tenancy/{n}"], n)
    # the same entries: bit for bit against the local step, by provenance
    # within 1e-6 against the JAX one; placed differently by design
    lk = lrt.state.keys[lrt.state.valid].numpy()
    dk = drt.state.keys[drt.state.valid].numpy()
    assert sorted(r.tobytes() for r in lk) == sorted(r.tobytes() for r in dk)
    assert len(dk) == int(drt.stats.inserts)
    dsrc = drt.state.source_id[drt.state.valid].numpy()
    jsrc = out[f"P/{index_name}/key_source"]
    assert_close(dk[np.argsort(dsrc)], out[f"P/{index_name}/keys"][
        np.argsort(jsrc)], "keys by provenance", tol=KEY_TOL)
    per_shard = drt.state.valid.reshape(4, -1).sum(1)
    assert bool((per_shard > 0).all()), per_shard


def test_replicated_leaves_agree_across_shards():
    """Each shard body gets its own copy of stats, policy and fusion state;
    after a step every shard's copy is the same, and the input runtime's
    replicated tensors are untouched."""
    cache = parity_cache("exact")
    dc = DistributedCache(cache, cpu_mesh(4))
    rt = dc.init()
    before = {n: getattr(rt.stats, n).clone() for n in STATS}
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((PB, PD)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((PB, PW, PD)).astype(
        np.float32))
    wl = torch.from_numpy(rng.integers(0, PW + 1, PB).astype(np.int32))
    tid = torch.from_numpy(rng.integers(0, 2, PB).astype(np.int32))
    mv = torch.zeros((PB, 8), dtype=torch.int32)
    mvl = torch.full((PB,), 8, dtype=torch.int32)
    firsts, _, outs = dc._spmd(rt, lambda r, comm: dc.local.step(
        r, q, mv, mvl, 0.0, tenant_id=tid, window=w, window_len=wl,
        comm=comm))
    for o in outs[1:]:
        for n in STATS:
            assert torch.equal(getattr(o.stats, n), getattr(outs[0].stats, n))
        assert torch.equal(o.policy_state, outs[0].policy_state)
        for f in dataclasses.fields(FusionState):
            assert torch.equal(getattr(o.fusion, f.name),
                               getattr(outs[0].fusion, f.name))
        for f in ("n_inserts", "ptr"):
            assert torch.equal(getattr(o.state, f), getattr(outs[0].state, f))
    for res in firsts[1:]:
        for f in ("hit", "near", "score", "index", "values", "source_id",
                  "topk_index"):
            assert torch.equal(getattr(res, f), getattr(firsts[0], f))
    assert int(outs[0].stats.lookups) == PB
    assert all(torch.equal(getattr(rt.stats, n), before[n]) for n in STATS)


# --------------------------------------------------------------------- #
# reshard_runtime, array for array
@pytest.mark.parametrize("mesh_as", MESH_AS)
@pytest.mark.parametrize("partitioned", [False, True],
                         ids=["plain", "part"])
@pytest.mark.parametrize("old,new", RESHARD, ids=lambda x: str(x))
def test_reshard_runtime_equals_jax(jax_side, old, new, partitioned,
                                    mesh_as):
    tag = "part" if partitioned else "plain"
    part = reshard_partition() if partitioned else None
    flat = checkpoint.load_checkpoint_flat(
        str(jax_side["dir"] / f"flat_{old}_{tag}"))
    cache = SemanticCache(reshard_config(), partition=part)
    template = cache.init("cpu") if new == 1 else DistributedCache(
        cache, cpu_mesh(new, mesh_as=mesh_as)).init()
    got = checkpoint.runtime_to_numpy(checkpoint.reshard_runtime(
        flat, template, old_shards=old, new_shards=new, partition=part))
    prefix = f"R/{old}_{new}_{tag}/"
    want = {k[len(prefix):]: v for k, v in jax_side["out"].items()
            if k.startswith(prefix)}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got["runtime/state/n_inserts"]) == int(
        flat["runtime/state/valid"].sum())


# --------------------------------------------------------------------- #
# the engine: reshard on load, snapshots across the packages, async waves
def test_reshard_on_load(tmp_path):
    """A 1-shard snapshot: refused by a strict load on 4 shards, resharded
    1 -> 4 with every shard holding entries, the same hits and per-tenant
    inserts; and back 4 -> 1."""
    pairs = engine_pairs()
    reqs = [Request(query=p.question, tenant="acme", source_id=p.qa_id)
            for p in pairs[:8]]
    e1 = warmed_engine()
    assert all(r.cached for r in e1.process(reqs))
    e1.save_cache(str(tmp_path / "snap"))
    stats1 = e1.tenant_stats()
    e2 = make_engine(cpu_mesh(4))
    with pytest.raises(ValueError, match="shard"):
        e2.load_cache(str(tmp_path / "snap"), reshard=False)
    e2.load_cache(str(tmp_path / "snap"))
    per_shard = e2.state.valid.reshape(4, -1).sum(1)
    assert bool((per_shard > 0).all()), per_shard
    resp2 = e2.process(reqs)
    assert all(r.cached for r in resp2)
    stats2 = e2.tenant_stats()
    for t in ("acme", "zen"):
        assert stats2[t]["inserts"] == stats1[t]["inserts"], t
    e2.save_cache(str(tmp_path / "snap4"))
    e3 = make_engine()
    e3.load_cache(str(tmp_path / "snap4"))
    resp3 = e3.process(reqs)
    assert [r.answer for r in resp3] == [r.answer for r in resp2]
    assert all(r.cached for r in resp3)
    assert e3.tenant_stats()["zen"]["inserts"] == stats1["zen"]["inserts"]


@pytest.mark.parametrize("mesh_as", MESH_AS)
def test_jax_sharded_snapshot_restores_into_the_port(jax_side, mesh_as):
    """A 4-shard JAX engine's snapshot loads strictly into a 4-shard port
    engine and, resharded, into a 1-shard one; both serve the next requests
    as a JAX engine restored from it serves them."""
    out, snap = jax_side["out"], str(jax_side["dir"] / "jax4")
    want = {k: out[f"E/jax4/{k}"] for k in ("cached", "answer", "score")}
    follow = engine_requests(engine_pairs(), 4)
    p4 = make_engine(cpu_mesh(4, mesh_as=mesh_as))
    p4.load_cache(snap, reshard=False)
    flat = checkpoint.open_checkpoint(snap)
    for k, x in checkpoint.runtime_to_numpy(p4.runtime).items():
        assert_close(x, flat[k], k, tol=0.0)
    same_responses(responses_of(p4.process(follow)), want, "strict 4 -> 4")
    assert p4.tenant_stats() == json.loads(str(out["E/jax4/tenant_stats"]))
    p1 = make_engine()
    p1.load_cache(snap)
    same_responses(responses_of(p1.process(follow)), want, "resharded 4 -> 1")


@pytest.mark.parametrize("mesh_as", MESH_AS)
def test_port_sharded_snapshot_restores_into_jax(jax_side, mesh_as):
    """The port's 4-shard snapshot, loaded strictly into a 4-shard JAX
    engine (in the subprocess), serves the next requests as the port
    engine served them."""
    out = jax_side["out"]
    same_responses({k: out[f"E/port4_in_jax/{mesh_as}/{k}"] for k in
                    ("cached", "answer", "score")},
                   jax_side["port_follow"][mesh_as], "port snapshot in JAX")
    assert json.loads(str(out[f"E/port4_in_jax/{mesh_as}/tenant_stats"])) \
        == jax_side["port_stats"][mesh_as]


@pytest.mark.parametrize("mesh_as", MESH_AS)
def test_async_waves_on_a_sharded_engine_equal_the_sync_run(mesh_as):
    """Waves of a batch through the async scheduler on a 4-shard engine
    equal the sync sharded run request by request (DESIGN.md §19.4)."""
    reqs = engine_requests(engine_pairs(), 5)
    sync = warmed_engine(cpu_mesh(4, mesh_as=mesh_as))
    want = responses_of(sync.process(reqs))
    eng = warmed_engine(cpu_mesh(4, mesh_as=mesh_as))

    async def drive():
        sched = SchedulerConfig(max_batch=8, max_wait_ms=50.0,
                                coalesce=False,
                                tenant_weights=eng.registry.weights())
        async with AsyncCacheServer(eng, sched) as server:
            return await run_waves(server.submit_request, reqs, wave=8)
    got = responses_of(asyncio.run(drive()).responses)
    same_responses(got, want, "async waves vs sync")
    assert eng.stats.host() == sync.stats.host()
    assert eng.tenant_stats() == sync.tenant_stats()
    assert got["cached"].any() and not got["cached"].all()


# --------------------------------------------------------------------- #
# failures, refusals and device defaults
class FlakyIndex(ExactIndex):
    """ExactIndex whose search raises on one shard while ``armed``: the
    shard is told by its slab keys' storage (``armed``, a data pointer)."""

    armed = None

    def search(self, istate, queries, keys, alive, **kw):
        if keys.data_ptr() == FlakyIndex.armed:
            raise RuntimeError("injected shard failure")
        return super().search(istate, queries, keys, alive, **kw)


def test_a_raising_shard_body_fails_the_call_and_frees_every_thread():
    cfg = CacheConfig(dim=8, capacity=64, value_len=2, ttl=None)
    dc = DistributedCache(SemanticCache(cfg, index=FlakyIndex()),
                          cpu_mesh(4))
    rt = dc.init()
    q = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 8)).astype(np.float32))
    rt = dc.insert(rt, q, torch.zeros((4, 2), dtype=torch.int32),
                   torch.full((4,), 2, dtype=torch.int32), 0.0)
    caught, after = [], []

    def calls():
        FlakyIndex.armed = rt.shards[2].state.keys.data_ptr()
        try:
            dc.lookup(rt, q, 1.0)
        except RuntimeError as exc:
            caught.append(exc)
        finally:
            FlakyIndex.armed = None
        # the next call needs every shard thread free again
        after.append(dc.lookup(rt, q, 1.0)[0])
    t = threading.Thread(target=calls, daemon=True)
    t.start()
    t.join(timeout=30)           # the per-test limit: no thread may hang
    assert not t.is_alive(), "a sharded call hung after a failed shard"
    assert len(caught) == 1 and "injected" in str(caught[0])
    assert len(after) == 1 and bool(after[0].hit.all())


def test_mesh_refusals():
    cfg = CacheConfig(dim=8, capacity=60)
    with pytest.raises(ValueError, match="divisible"):
        DistributedCache(SemanticCache(cfg), cpu_mesh(8))
    part = TenantRegistry.uniform(("a", "b", "c")).partition(100)
    with pytest.raises(ValueError, match="multiples"):
        DistributedCache(SemanticCache(CacheConfig(dim=8, capacity=100),
                                       partition=part), cpu_mesh(4))
    with pytest.raises(ValueError, match="no axis"):
        DistributedCache(SemanticCache(cfg), cpu_mesh(2), ("model",))
    # a device a shard (ROADMAP A6b): accepted in shard-major order, the
    # first shard's the controller's; a count that is not the shape's refused
    mesh = make_mesh((2, 2), ("data", "model"), device=["cpu"] * 4)
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="4 shards; got 3 devices"):
        make_mesh((2, 2), ("data", "model"), device=["cpu"] * 3)
    assert shard_axes(cpu_mesh(4, 2, names=("data", "model")),
                      ("data", "model")) == 8
    with pytest.raises(ValueError, match="per-shard capacity"):
        CachedEngine(CacheConfig(dim=8, capacity=64),
                     SimulatedLLMBackend([]), batch_size=32,
                     mesh=cpu_mesh(4), device="cpu")
    with pytest.raises(ValueError, match="shard"):
        CachedEngine(CacheConfig(dim=8, capacity=512),
                     SimulatedLLMBackend([]), batch_size=64,
                     registry=TenantRegistry.uniform(("a", "b")),
                     mesh=cpu_mesh(8), device="cpu")


def test_cuda_mesh_and_fusion_state_default_to_the_card():
    """Fusion state used to default to the CPU (``FusionState.make``,
    ``DecayMeanFusion.init_state``, ``AttentionFusion.init_state`` took
    ``device="cpu"``); like every entry point they now default to CUDA and
    raise without it unless the caller asks for the CPU. A mesh on CUDA
    raises here too."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    for fn in (FusionState.make, DecayMeanFusion.init_state,
               AttentionFusion.init_state):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for call in (lambda: FusionState.make(0.8),
                 lambda: DecayMeanFusion().init_state(),
                 lambda: AttentionFusion().init_state(),
                 lambda: make_mesh((4,), ("data",))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    for st in (FusionState.make(0.8, device="cpu"),
               DecayMeanFusion().init_state("cpu"),
               AttentionFusion().init_state("cpu")):
        assert st.context_weight.device.type == "cpu"


def test_launch_counter_and_shard_turns_under_thread_stress():
    """More threads than cores with a short switch interval: the launch
    counter loses no increment, and a 16-shard cache's turns keep its
    round robin and its exchanges exact (a lost update would unbalance the
    shards or miss a hit)."""
    from repro_torch.kernels import build
    table = {"stress": 0}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            build.count_launch(table, "stress") for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert table["stress"] == 16 * 2000
        # a shard's ring must hold a whole batch (the engine checks it)
        dc = DistributedCache(SemanticCache(CacheConfig(
            dim=8, capacity=512, value_len=2, ttl=None)), cpu_mesh(16))
        rt = dc.init()
        rng = np.random.default_rng(2)
        for b in range(4):
            q = torch.from_numpy(rng.standard_normal((24, 8)).astype(
                np.float32))
            rt = dc.insert(rt, q, torch.zeros((24, 2), dtype=torch.int32),
                           torch.full((24,), 2, dtype=torch.int32), float(b))
            res, rt = dc.lookup(rt, q, float(b) + 0.5)
            assert bool(res.hit.all())
            assert bool(((res.score - 1).abs() < 1e-6).all())
        assert rt.state.valid.reshape(16, -1).sum(1).tolist() == [6] * 16
    finally:
        sys.setswitchinterval(old)
