"""The port on the card: the CUDA cosine top-k kernels (shared mask, per-row
interval, dense per-row mask; k up to the IVF probe's 16 and past it; the
shared form's tensor-core tiles at their edges, and its hit decisions the
same in a batch of 128 as one row at a time; the interval and dense forms'
outputs independent of how rows are laid out, the dense form under
region-shaped, random and skewed masks, bit for bit the interval form's at
an interval-shaped mask, and its pass 0 against its plain version) and
the IVF candidate top-k (with and without the probe's grouping, a skewed
bucket table among its cases) against their plain PyTorch versions, the three
per-row-scale int8 forms and ``quantize_keys`` against theirs, and the serve
loop, single- and multi-tenant and through the IVF index, on CUDA against
the same loop on the CPU; the prefill flash-attention and decode-attention
kernels against their plain versions, their wrappers' refusals, and the
model-backed miss path's launches and answers on CUDA against the CPU; the
async front end's lockstep waves on CUDA against the sync card run and the
CPU, the tracing engine's spans on CUDA, sessions, near-hit bands and
resilience on CUDA against the CPU, and the sharded cache (four shards on
the card: the serve loop against the unsharded card run and the CPU, IVF
against a restored CPU engine, reshard on load), the flash kernel with
attention sinks, the moe, ssm, hybrid, audio and vlm families' reduced
models on CUDA against the CPU, and training: the flash-attention
backward kernel against its plain version, a training step's loss and
gradients through the kernels and the training driver against the CPU;
the MiniLM encoder on CUDA against the CPU, the dry run's sharded
cache pair on CUDA, the sharded ``Model`` on a one-rank NCCL mesh
bit for bit against the unsharded one, and the ``quickstart`` and
``serve_cached_chatbot`` examples on CUDA against ``--device cpu``.
Every test here needs a CUDA
device and skips without one. The file imports
neither jax nor the JAX package, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

It also holds the seeded kernel inputs that ``test_torch_kernels.py`` feeds
to the JAX package on the CPU."""
import asyncio
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.core.index import IVFIndex
from repro_torch.core.types import CacheConfig
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.kernels import cosine_topk as kmod
from repro_torch.kernels import decode_attention as kdec
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ivf_topk as kivf
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import threefry as kthreefry
from repro_torch.launch import serve
from repro_torch.models.model import Model
from repro_torch.obs import TraceConfig, Tracer
from repro_torch.serving import (AsyncCacheServer, ModelBackend,
                                 SchedulerConfig, run_waves)

CASES = [  # (B, N, d, k, mask)
    (4, 100, 32, 1, "random"),
    (3, 517, 64, 4, "random"),
    (9, 300, 384, 8, "random"),
    (5, 130, 48, 4, "none"),
    (6, 257, 64, 8, "few"),
]


def make_inputs(b, n, d, key_dtype, mask, k, seed):
    """Unit queries and keys, a validity mask and planted exact ties: slots
    t < u < v hold one key row, and query 0 is that row."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    keys = rng.standard_normal((n, d)).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=1, keepdims=True)
    ties = np.array([n // 7, n // 2, n - 1])
    keys[ties] = keys[ties[0]]
    q[0] = keys[ties[0]]
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    if mask == "random":
        valid = rng.random(n) < 0.7
        valid[ties] = True
    elif mask == "none":
        valid = np.zeros(n, dtype=bool)
    else:  # fewer than k visible
        valid = np.zeros(n, dtype=bool)
        valid[ties[:max(k - 1, 1)]] = True
    if key_dtype == "int8":
        keys = np.clip(np.round(keys * 127.0), -127, 127).astype(np.int8)
    return q, keys, valid, ties


INTERVAL_CASES = [  # (B, N, d, k)
    (4, 100, 32, 1),
    (9, 300, 64, 4),
    (13, 517, 48, 8),
    (70, 1000, 32, 4),    # two 64-row query tiles with different intervals
]


def make_interval_inputs(b, n, d, key_dtype, k, seed):
    """Unit queries and keys over three contiguous regions [0, e1), [e1, e2),
    [e2, n); each row sees one region (every fifth row none), ``valid``
    holds 70% of the slots, and ``mask`` is a dense (B, N) per-row mask:
    the row's region and valid slots, with a fifth of them knocked out.

    Planted ties across the region edges: slots e1 - 1, e1, e1 + 1 and e2
    hold one key row, and query rows 0, 1, 2 are that row in regions 0, 1
    and 2, so each must find only the copies inside its own region. Returns
    (q, keys, valid, starts, sizes, mask, ties), ``ties[r]`` the tie slots
    row r may see, lowest first."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    keys = rng.standard_normal((n, d)).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=1, keepdims=True)
    e1, e2 = n // 3, 2 * n // 3
    region_start = np.array([0, e1, e2], np.int32)
    region_size = np.array([e1, e2 - e1, n - e2], np.int32)
    tenant = rng.integers(0, 3, b)
    tenant[:3] = np.arange(3)[:min(b, 3)]
    starts = region_start[tenant]
    sizes = region_size[tenant]
    sizes[4::5] = 0
    tie_slots = np.array([e1 - 1, e1, e1 + 1, e2])
    keys[tie_slots] = keys[tie_slots[0]]
    q[:3] = keys[tie_slots[0]]
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    valid = rng.random(n) < 0.7
    valid[tie_slots] = True
    cols = np.arange(n)[None, :]
    inside = (cols >= starts[:, None]) & (cols < (starts + sizes)[:, None])
    mask = valid[None, :] & inside & (rng.random((b, n)) < 0.8)
    mask[:, tie_slots] = (valid[None, :] & inside)[:, tie_slots]
    ties = [tie_slots[(tie_slots >= starts[r])
                      & (tie_slots < starts[r] + sizes[r])][:k]
            for r in range(min(b, 3))]
    if key_dtype == "int8":
        keys = np.clip(np.round(keys * 127.0), -127, 127).astype(np.int8)
    return q, keys, valid, starts, sizes, mask, ties


IVF_CASES = [  # (B, N, M, d, k)
    (4, 100, 37, 32, 4),
    (6, 300, 300, 64, 8),
    (9, 517, 130, 48, 16),
    (3, 64, 20, 20, 4),      # 16-byte loads only for f32: d*2, d % 16 != 0
    (70, 200, 2100, 32, 4),  # B > 64, M past one 2,048-position block
]
# on the card only: without a probe each row's chunk of 2,048 positions is
# a bucket of its own; one full chunk, row 0's tie across two chunks, a
# 1-position last chunk
IVF_CHUNK_CASES = [(5, 300, 2048, 32, 4), (5, 300, 3001, 32, 4),
                   (5, 300, 4097, 32, 4)]


def make_ivf_inputs(b, n, m, d, k, key_dtype, seed):
    """Unit queries and keys and a (B, M) candidate matrix, half of it -1,
    each row's ids drawn from 48 slots of its own. Row 1 sees nothing, row
    2 fewer than k ids. Planted ties: slots u1 < u2 hold one key row, and
    row 0 (that row as its query) has u2 at a lower position than u1, so it
    must return u2 first; row 3 has slot t at two positions (no dedup here),
    so it must return t twice. The seed is advanced until the scores of each
    row's distinct key rows lie more than 1e-6 apart (in float64, keys as
    stored), so no decision hinges on the summation order. Returns
    (q, keys, cand, ties), ``ties[r]`` the ids row r must start with."""
    for attempt in range(100):
        out = _ivf_inputs(b, n, m, d, k, key_dtype, seed + 1000 * attempt)
        if _scores_apart(*out[:3], key_dtype):
            return out
    raise AssertionError("no seed gave scores 1e-6 apart")


def _ivf_inputs(b, n, m, d, k, key_dtype, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    keys = rng.standard_normal((n, d)).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=1, keepdims=True)
    pool = np.stack([rng.permutation(n)[:min(n, 48)] for _ in range(b)])
    cand = np.take_along_axis(pool, rng.integers(0, pool.shape[1], (b, m)),
                              axis=1).astype(np.int32)
    cand[rng.random((b, m)) < 0.5] = -1
    u1, u2, t = n // 3, n // 2, n // 5
    keys[u2] = keys[u1]
    cand[np.isin(cand, (u1, u2, t))] = -1
    ties = {}
    if b > 1:
        cand[1] = -1
    if b > 2:
        keep = np.flatnonzero(cand[2] >= 0)[:k - 1]
        cand[2, np.setdiff1d(np.arange(m), keep)] = -1
    q[0] = keys[u1]
    cand[0, m - 1], cand[0, m // 2] = u1, u2
    ties[0] = [u2, u1]
    if b > 3:
        q[3] = keys[t]
        cand[3, 3], cand[3, m - 2] = t, t
        ties[3] = [t, t]
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    if key_dtype == "int8":
        keys = np.clip(np.round(keys * 127.0), -127, 127).astype(np.int8)
    return q, keys, cand, ties


GROUPED_CASES = [  # (B, C, cap, P, N, d, k)
    (9, 6, 16, 3, 60, 48, 4),
    (40, 12, 100, 5, 900, 64, 8),    # cap 100: two 64-member tiles
    (70, 8, 37, 4, 300, 20, 4),      # d=20: bf16 and int8 rows staged by element
    (33, 10, 24, 6, 200, 32, 32),    # k=32: more than a group's 8 entries
    (12, 6, 40, 3, 300, 2000, 4),    # d=2000: 8-row tiles, chunks of the query
]


def make_grouped_ivf_inputs(b, c, cap, p, n, d, k, key_dtype, seed):
    """The IVF kernel's grouped operands: a bucket table (C, cap) whose
    buckets hold live members at random positions (bucket 0 full, bucket 1
    empty, the others a random share; a slot may sit in several buckets),
    each row's P distinct probes with bucket 0 probed by every row, and
    cand = buckets[probe] with a third of the entries -1 (row 1 sees
    nothing, row 2 fewer than k ids). Planted ties across two buckets:
    slots u1 < u2 hold one key row, query 0 is that row, u2 sits in the
    bucket row 0 probes first and u1 in the next, so row 0 must return u2
    (the lower position) before u1. Returns (q, keys, cand, probe, buckets,
    ties)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    keys = rng.standard_normal((n, d)).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=1, keepdims=True)
    u1, u2 = n // 3, n // 2
    keys[u2] = keys[u1]
    others = np.setdiff1d(np.arange(n), (u1, u2))
    live = rng.random((c, cap)) < rng.random((c, 1))
    live[0], live[1] = True, False
    buckets = np.where(live, rng.choice(others, (c, cap)), -1).astype(np.int32)
    probe = np.stack([np.concatenate([[0], 1 + rng.permutation(c - 1)[:p - 1]])
                      for _ in range(b)])
    rest = rng.permutation(np.setdiff1d(np.arange(c), (0, 2, 3)))
    probe[0] = np.concatenate([[2, 3, 0], rest])[:p]
    probe = probe.astype(np.int32)
    buckets[2, 0], buckets[3, 0] = u2, u1
    cand = buckets[probe].reshape(b, p * cap)
    cand[rng.random(cand.shape) < 1 / 3] = -1
    cand[0, 0], cand[0, cap] = u2, u1
    if b > 1:
        cand[1] = -1
    if b > 2:
        keep = np.flatnonzero(cand[2] >= 0)[:k - 1]
        cand[2, np.setdiff1d(np.arange(p * cap), keep)] = -1
    q[0] = keys[u1]
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    if key_dtype == "int8":
        keys = np.clip(np.round(keys * 127.0), -127, 127).astype(np.int8)
    return q, keys, cand, probe, buckets, {0: [u2, u1]}


def assert_topk_close(got, want1, k, tol):
    """A kernel's (scores, ids) against the plain version's top-(k+1):
    scores within ``tol``, the same empty entries, and the same ids wherever
    a score lies more than ``tol`` from both neighbours (many distinct rows
    may score within the f32 reorderings of each other)."""
    ks, ki = (x.cpu() for x in got)
    rs1, ri1 = (x.cpu() for x in want1)
    rs1 = torch.cat([rs1, torch.full((rs1.shape[0], k + 1 - rs1.shape[1]),
                                     -math.inf)], 1)
    ri1 = torch.cat([ri1, torch.full((ri1.shape[0], k + 1 - ri1.shape[1]),
                                     -1, dtype=ri1.dtype)], 1)
    rs, ri = rs1[:, :k], ri1[:, :k]
    empty = ri < 0
    assert torch.equal(empty, ki < 0)
    assert bool(torch.all(torch.isneginf(ks[empty])))
    torch.testing.assert_close(ks[~empty], rs[~empty], rtol=0, atol=tol)
    gap = torch.full(rs1.shape, math.inf)
    diff = (rs1[:, 1:] - rs1[:, :-1]).abs()
    gap[:, 1:] = torch.minimum(gap[:, 1:], diff)
    gap[:, :-1] = torch.minimum(gap[:, :-1], diff)
    apart = (gap[:, :k] > tol) & ~empty
    assert torch.equal(ki[apart], ri[apart])


def _scores_apart(q, keys, cand, key_dtype):
    k64 = keys_to_torch(keys, key_dtype).to(torch.float64).numpy()
    if key_dtype == "int8":
        k64 = k64 / 127.0
    for qr, row in zip(q.astype(np.float64), cand):
        ids = np.unique(row[(row >= 0) & (row < len(keys))])
        scores = np.sort(np.unique(k64[ids], axis=0) @ qr)
        if scores.size > 1 and np.min(np.diff(scores)) <= 1e-6:
            return False
    return True


def keys_to_torch(keys, key_dtype):
    t = torch.from_numpy(keys)
    return t.to(torch.bfloat16) if key_dtype == "bf16" else t


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("key_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("b,n,d,k,mask", CASES)
def test_cuda_kernel_matches_plain_version(cuda_device, b, n, d, k, mask,
                                           key_dtype):
    q, keys, valid, _ = make_inputs(b, n, d, key_dtype, mask, k, seed=n + k)
    args = (torch.from_numpy(q).to(cuda_device),
            keys_to_torch(keys, key_dtype).to(cuda_device),
            torch.from_numpy(valid).to(cuda_device))
    before = kmod.launches["cosine_topk"]
    ks, ki = kmod.cosine_topk_cuda(*args, k)
    assert kmod.launches["cosine_topk"] == before + 1
    rs, ri = tref.cosine_topk_ref(*[a.cpu() for a in args], k)
    torch.testing.assert_close(ks.cpu(), rs, rtol=0, atol=1e-5)
    assert torch.equal(ki.cpu(), ri)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["interval", "masked"])
@pytest.mark.parametrize("key_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("b,n,d,k", INTERVAL_CASES)
def test_cuda_per_row_kernels_match_plain_versions(cuda_device, b, n, d, k,
                                                   key_dtype, variant):
    q, keys, valid, starts, sizes, mask, ties = make_interval_inputs(
        b, n, d, key_dtype, k, seed=b + n + k)
    dev = cuda_device
    qt = torch.from_numpy(q).to(dev)
    kt = keys_to_torch(keys, key_dtype).to(dev)
    name = f"cosine_topk_{variant}"
    before = kmod.launches[name]
    if variant == "interval":
        ops = [torch.from_numpy(x).to(dev) for x in (valid, starts, sizes)]
        ks, ki = kmod.cosine_topk_interval_cuda(qt, kt, *ops, k)
        rs, ri = tref.cosine_topk_interval_ref(
            qt.cpu(), kt.cpu(), *[x.cpu() for x in ops], k)
    else:
        mt = torch.from_numpy(mask).to(dev)
        ks, ki = kmod.cosine_topk_masked_cuda(qt, kt, mt, k)
        rs, ri = tref.cosine_topk_ref(qt.cpu(), kt.cpu(), mt.cpu(), k)
    assert kmod.launches[name] == before + 1
    tol = 1e-2 if key_dtype == "bf16" else 1e-5
    torch.testing.assert_close(ks.cpu(), rs, rtol=0, atol=tol)
    if key_dtype != "bf16":
        assert torch.equal(ki.cpu(), ri)
    empty = sizes == 0
    assert bool(torch.all(ki.cpu()[torch.from_numpy(empty)] == -1))
    for r, want in enumerate(ties):
        assert ki[r, :len(want)].cpu().tolist() == want.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16384, 384), (1000, 1536)])
def test_cuda_quantize_keys_is_bitwise_the_cpu(cuda_device, shape):
    keys = np.random.default_rng(shape[0]).standard_normal(shape).astype(
        np.float32)
    keys[7] = 0.0
    cq, cs = kmod.quantize_keys(torch.from_numpy(keys).to(cuda_device))
    hq, hs = kmod.quantize_keys(torch.from_numpy(keys))
    assert torch.equal(cq.cpu(), hq)
    assert torch.equal(cs.cpu().view(torch.int32), hs.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,k,mask",
                         CASES + [(70, 16383, 1536, 32, "random")])
def test_cuda_quant_kernel_matches_plain_version(cuda_device, b, n, d, k,
                                                 mask):
    q, keys, valid, ties = make_inputs(b, n, d, "f32", mask, k, seed=n + k)
    kq, sc = kmod.quantize_keys(torch.from_numpy(keys).to(cuda_device))
    qt = torch.from_numpy(q).to(cuda_device)
    vt = torch.from_numpy(valid).to(cuda_device)
    before = kmod.launches["quant_cosine_topk"]
    ks, ki = ops.quant_cosine_topk(qt, kq, sc, vt, k=k)
    assert kmod.launches["quant_cosine_topk"] == before + 1
    rs, ri = tref.quant_cosine_topk_ref(qt.cpu(), kq.cpu(), sc.cpu(),
                                        vt.cpu(), k)
    torch.testing.assert_close(ks.cpu(), rs, rtol=0, atol=1e-5)
    assert torch.equal(ki.cpu(), ri)
    if mask != "none":
        m = min(k, 3, int(valid.sum()))
        assert ki[0, :m].cpu().tolist() == ties[:m].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["interval", "masked"])
@pytest.mark.parametrize("b,n,d,k", INTERVAL_CASES + [(7, 1000, 1536, 16)])
def test_cuda_quant_per_row_kernels_match_plain_versions(cuda_device, b, n,
                                                         d, k, variant):
    q, keys, valid, starts, sizes, mask, ties = make_interval_inputs(
        b, n, d, "f32", k, seed=b + n + k)
    dev = cuda_device
    qt = torch.from_numpy(q).to(dev)
    kq, sc = kmod.quantize_keys(torch.from_numpy(keys).to(dev))
    name = f"quant_cosine_topk_{variant}"
    before = kmod.launches[name]
    if variant == "interval":
        ops_ = [torch.from_numpy(x).to(dev) for x in (valid, starts, sizes)]
        ks, ki = kmod.quant_cosine_topk_interval_cuda(qt, kq, sc, *ops_, k)
        rs, ri = tref.quant_cosine_topk_interval_ref(
            qt.cpu(), kq.cpu(), sc.cpu(), *[x.cpu() for x in ops_], k)
    else:
        mt = torch.from_numpy(mask).to(dev)
        ks, ki = ops.quant_cosine_topk(qt, kq, sc, mt, k=k)
        rs, ri = tref.quant_cosine_topk_ref(qt.cpu(), kq.cpu(), sc.cpu(),
                                            mt.cpu(), k)
    assert kmod.launches[name] == before + 1
    torch.testing.assert_close(ks.cpu(), rs, rtol=0, atol=1e-5)
    assert torch.equal(ki.cpu(), ri)
    assert bool(torch.all(ki.cpu()[torch.from_numpy(sizes == 0)] == -1))
    for r, want in enumerate(ties):
        assert ki[r, :len(want)].cpu().tolist() == want.tolist()


EDGE_CASES = [  # (B, N, d, k) around the tensor-core form's 128 x 128 tile
    (128, 16383, 384, 4),
    (127, 16385, 100, 1),     # d not a whole 32-dim slice
    (129, 16383, 1536, 16),   # two query tiles; k > 4: warp-held lists
    (200, 16385, 1, 32),      # d = 1: every score is +-1, ties everywhere
    (128, 16385, 1536, 32),
    (129, 16385, 384, 4),
    (200, 16383, 100, 4),
    (1, 16383, 384, 4),       # one row: the 4-row tiles
    (1, 16385, 1, 1),
    (127, 127, 384, 16),      # a small slab: the 4-row tiles
    (200, 129, 1536, 4),
    (128, 1, 100, 1),
    (129, 127, 1, 32),
]
# every key type: bf16 and int8 keys, and the plain version's operands, are
# the same numbers, exact in f32
EDGE_TOL = 1e-5
# ids must agree wherever a score lies farther than this from its
# neighbours: twice the largest score error of the tensor-core form on the
# card (1.01e-6 over chip_smoke.py's kernel cases)
ID_GAP = 2e-6


def _hold_to_plain(ks, ki, rs1, ri1, k, tol):
    """The kernel's (scores, ids) against the plain version's top-(k+1):
    the same empty slots, scores within ``tol``, and the same ids wherever a
    score lies more than ``ID_GAP`` from its neighbours (the next entry past
    the list included) or the row's scores agree bit for bit. Returns the
    entries whose ids differ: (row, place, kernel id, plain id, kernel
    score, plain score, the plain score's gap to its nearest neighbour)."""
    ks, ki, rs1, ri1 = (x.cpu() for x in (ks, ki, rs1, ri1))
    b = ks.shape[0]
    if rs1.shape[1] < k + 1:
        pad = k + 1 - rs1.shape[1]
        rs1 = torch.cat([rs1, torch.full((b, pad), -np.inf)], dim=1)
        ri1 = torch.cat([ri1, torch.full((b, pad), -1, dtype=ri1.dtype)],
                        dim=1)
    rs, ri = rs1[:, :k], ri1[:, :k]
    empty = ri < 0
    assert torch.equal(empty, ki < 0)
    assert bool(torch.isneginf(ks[empty]).all())
    if (~empty).any():
        assert (ks[~empty] - rs[~empty]).abs().max().item() <= tol
    gap = torch.full((b, k + 1), np.inf)
    diff = (rs1[:, 1:] - rs1[:, :-1]).abs()
    gap[:, 1:] = torch.minimum(gap[:, 1:], diff)
    gap[:, :-1] = torch.minimum(gap[:, :-1], diff)
    apart = (gap[:, :k] > ID_GAP) & ~empty
    assert torch.equal(ki[apart], ri[apart])
    same = (ks.view(torch.int32) == rs.view(torch.int32)).all(dim=1)
    assert torch.equal(ki[same], ri[same])
    return [(r, c, int(ki[r, c]), int(ri[r, c]), float(ks[r, c]),
             float(rs[r, c]), float(gap[r, c]))
            for r, c in ((ki != ri) & ~empty).nonzero().tolist()]


@pytest.mark.cuda
@pytest.mark.parametrize("key_dtype", ["f32", "bf16", "int8", "quant"])
@pytest.mark.parametrize("b,n,d,k", EDGE_CASES)
def test_cuda_shared_kernel_at_tile_edges(cuda_device, b, n, d, k,
                                          key_dtype):
    quant = key_dtype == "quant"
    q, keys, valid, ties = make_inputs(b, n, d, "f32" if quant else
                                       key_dtype, "random", k, seed=b + n + d)
    qt = torch.from_numpy(q).to(cuda_device)
    vt = torch.from_numpy(valid).to(cuda_device)
    kt = keys_to_torch(keys, key_dtype).to(cuda_device)
    slab = kmod.quantize_keys(kt) if quant else (kt,)
    name = "quant_cosine_topk" if quant else "cosine_topk"
    before = kmod.launches[name]
    ks, ki = getattr(kmod, f"{name}_cuda")(qt, *slab, vt, k)
    assert kmod.launches[name] == before + 1
    rs1, ri1 = getattr(tref, f"{name}_ref")(qt, *slab, vt, k + 1)
    _hold_to_plain(ks, ki, rs1, ri1, k, EDGE_TOL)
    if d > 1:   # query 0 is the key row planted at the tie slots
        want = np.unique(ties)[:k]
        assert ki[0, :len(want)].cpu().tolist() == want.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("key_dtype", ["f32", "int8"])
def test_cuda_batch_size_keeps_hit_decisions(cuda_device, key_dtype):
    """A query scored in a batch of 128 (tensor-core tiles, 3xTF32) and on
    its own (4-row tiles, f32 FMAs) gets scores within 1e-5 and the same hit
    decision at 0.8 wherever its score lies farther than 1e-5 from 0.8."""
    rng = np.random.default_rng(18)
    n, d, b, threshold = 16384, 384, 128, 0.8
    keys = rng.standard_normal((n, d)).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=1, keepdims=True)
    noise = rng.standard_normal((b, d)).astype(np.float32)
    noise /= np.linalg.norm(noise, axis=1, keepdims=True)
    # a key plus noise: top-1 scores spread over 0.7 to 0.9
    w = rng.uniform(0.7, 0.9, b).astype(np.float32)[:, None]
    q = w * keys[:b] + np.sqrt(1 - w * w) * noise
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    if key_dtype == "int8":
        keys = np.clip(np.round(keys * 127.0), -127, 127).astype(np.int8)
    qt = torch.from_numpy(q).to(cuda_device)
    kt = torch.from_numpy(keys).to(cuda_device)
    vt = torch.ones(n, dtype=torch.bool, device=cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert kmod.split(b, n, sms, shared=True)[2] == kmod.BLOCK_Q_TC
    assert kmod.split(1, n, sms, shared=True)[2] == kmod.BLOCK_Q_NARROW
    whole = kmod.cosine_topk_cuda(qt, kt, vt, 4)[0][:, 0].cpu()
    alone = torch.cat([kmod.cosine_topk_cuda(qt[r:r + 1], kt, vt, 4)[0]
                       for r in range(b)])[:, 0].cpu()
    assert (whole - alone).abs().max().item() <= 1e-5
    far = (whole - threshold).abs() > 1e-5
    assert torch.equal((whole >= threshold)[far], (alone >= threshold)[far])
    assert 0 < int((whole >= threshold).sum()) < b


def make_layout_inputs(b, n, d, regions, seed):
    """Unit queries and keys over ``regions`` equal slab regions; row r sees
    region r % regions (every fifth row nothing), and ``valid`` holds 70%
    of the slots. Returns (q, keys, valid, starts, sizes)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    keys = rng.standard_normal((n, d)).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=1, keepdims=True)
    size = n // regions
    starts = (np.arange(b) % regions * size).astype(np.int32)
    sizes = np.full(b, size, np.int32)
    sizes[4::5] = 0
    return q, keys, rng.random(n) < 0.7, starts, sizes


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("k", [1, 32])
@pytest.mark.parametrize("b", [1, 37, 128])
def test_cuda_interval_kernels_ignore_the_row_layout(cuda_device, b, k,
                                                     quant):
    """Rows round robin over the regions (every tile mixes them), sorted by
    region, and at random give each row the same top-k, bit for bit; the
    round-robin layout also equals the plain version."""
    q, keys, valid, starts, sizes = make_layout_inputs(b, 4096, 64, 4,
                                                       seed=b + k)
    dev = cuda_device
    kt = torch.from_numpy(keys).to(dev)
    scales = None
    if quant:
        kt, scales = kmod.quantize_keys(kt)
    name = "quant_cosine_topk_interval" if quant else "cosine_topk_interval"
    perms = {"round_robin": np.arange(b),
             "sorted": np.argsort(starts + (sizes == 0) * 4096,
                                  kind="stable"),
             "random": np.random.default_rng(b).permutation(b)}
    got = {}
    for layout, perm in perms.items():
        args = [torch.from_numpy(np.ascontiguousarray(x[perm])).to(dev)
                for x in (q, starts, sizes)]
        vt = torch.from_numpy(valid).to(dev)
        before = kmod.launches[name]
        if quant:
            ks, ki = kmod.quant_cosine_topk_interval_cuda(
                args[0], kt, scales, vt, args[1], args[2], k)
        else:
            ks, ki = kmod.cosine_topk_interval_cuda(args[0], kt, vt, args[1],
                                                    args[2], k)
        assert kmod.launches[name] == before + 1
        back = np.argsort(perm)   # to round-robin row order
        got[layout] = (ks.cpu()[back], ki.cpu()[back])
    for layout in ("sorted", "random"):
        assert torch.equal(got[layout][0].view(torch.int32),
                           got["round_robin"][0].view(torch.int32)), layout
        assert torch.equal(got[layout][1], got["round_robin"][1]), layout
    cpu = [torch.from_numpy(x) for x in (q, valid, starts, sizes)]
    if quant:
        rs, ri = tref.quant_cosine_topk_interval_ref(
            cpu[0], kt.cpu(), scales.cpu(), *cpu[1:], k)
    else:
        rs, ri = tref.cosine_topk_interval_ref(cpu[0], kt.cpu(), *cpu[1:], k)
    torch.testing.assert_close(got["round_robin"][0], rs, rtol=0, atol=1e-5)
    assert torch.equal(got["round_robin"][1], ri)
    assert bool(torch.all(ri[torch.from_numpy(sizes == 0)] == -1))


DENSE_CASES = [  # (B, N, d, k)
    (5, 1000, 64, 4),        # few rows: 4-row tiles
    (37, 4133, 48, 8),       # N % 128 != 0
    (128, 8192, 64, 4),      # four regions of 16 tiles
    (200, 4096, 32, 32),     # B > 128
]
DENSE_LAYOUTS = ["tenancy", "random", "skewed"]


def make_dense_inputs(b, n, d, layout, seed):
    """Unit queries and keys and a dense (B, N) mask. ``tenancy``: four
    equal regions, row r sees region r % 4 where 90% of the slots are
    valid; ``random``: each row an independent random 30% of N;
    ``skewed``: most rows the first region, every eighth row all of N.
    Every fifth row sees nothing. Planted ties across a 128-key tile edge
    and a region edge: slots 127, 128, e - 1 and e (e = N // 4) hold one
    key row; query rows 0 and 1 are that row, row 0 sees all four slots
    and row 1 only 128 and e. Returns (q, keys, mask, ties), ``ties[r]``
    the tie slots row r must find, lowest first."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    keys = rng.standard_normal((n, d)).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=1, keepdims=True)
    e = n // 4
    cols = np.arange(n)[None, :]
    if layout == "random":
        mask = rng.random((b, n)) < 0.3
    else:
        region = np.arange(b) % 4 if layout == "tenancy" else np.zeros(b, int)
        lo = region * e
        hi = np.where(region == 3, n, lo + e)
        mask = (cols >= lo[:, None]) & (cols < hi[:, None]) & \
            (rng.random(n) < 0.9)[None, :]
        if layout == "skewed":
            mask[::8] = True
    mask[4::5] = False
    tie_slots = np.array([127, 128, e - 1, e])
    keys[tie_slots] = keys[tie_slots[0]]
    q[:2] = keys[tie_slots[0]]
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    mask[:2, tie_slots] = False
    mask[0, tie_slots] = True
    mask[1, [128, e]] = True
    return q, keys, mask, {0: [127, 128, e - 1, e], 1: [128, e]}


def _dense_on_card(dev, key_dtype, q, keys, mask, k):
    """The dense wrapper of ``key_dtype`` ("quant": int8 keys with per-row
    scales) on the card, and its plain version's top-(k+1) on the same
    operands."""
    qt = torch.from_numpy(q).to(dev)
    mt = torch.from_numpy(mask).to(dev)
    if key_dtype == "quant":
        slab = kmod.quantize_keys(torch.from_numpy(keys).to(dev))
        name = "quant_cosine_topk_masked"
    else:
        stored = keys if key_dtype != "int8" else np.clip(
            np.round(keys * 127.0), -127, 127).astype(np.int8)
        slab = (keys_to_torch(stored, key_dtype).to(dev),)
        name = "cosine_topk_masked"
    before = kmod.launches[name]
    got = getattr(kmod, f"{name}_cuda")(qt, *slab, mt, k)
    assert kmod.launches[name] == before + 1
    plain = (tref.quant_cosine_topk_ref if key_dtype == "quant"
             else tref.cosine_topk_ref)(qt, *slab, mt, k + 1)
    return got, plain


@pytest.mark.cuda
@pytest.mark.parametrize("key_dtype", ["f32", "bf16", "int8", "quant"])
@pytest.mark.parametrize("layout", DENSE_LAYOUTS)
@pytest.mark.parametrize("b,n,d,k", DENSE_CASES)
def test_cuda_dense_kernel_matches_plain_version(cuda_device, b, n, d, k,
                                                 layout, key_dtype):
    """Region-shaped, random and skewed masks, rows that see nothing, and
    planted ties across a tile edge and a region edge, to the lowest
    slot."""
    q, keys, mask, ties = make_dense_inputs(b, n, d, layout, seed=b + n + k)
    (ks, ki), (rs1, ri1) = _dense_on_card(cuda_device, key_dtype, q, keys,
                                          mask, k)
    _hold_to_plain(ks, ki, rs1, ri1, k, EDGE_TOL)
    blind = torch.from_numpy(~mask.any(1))
    assert bool(torch.all(ki.cpu()[blind] == -1))
    assert bool(torch.all(torch.isneginf(ks.cpu()[blind])))
    for r, want in ties.items():
        if r < b:
            want = want[:k]
            assert ki[r, :len(want)].cpu().tolist() == want


@pytest.mark.cuda
@pytest.mark.parametrize("key_dtype", ["f32", "bf16", "int8", "quant"])
@pytest.mark.parametrize("layout", DENSE_LAYOUTS)
def test_cuda_dense_kernel_ignores_the_row_layout(cuda_device, layout,
                                                  key_dtype):
    """The same rows in their own order and permuted at random give each
    row the same top-k, bit for bit."""
    b, n, d, k = 128, 8192, 64, 4
    q, keys, mask, _ = make_dense_inputs(b, n, d, layout, seed=7)
    perm = np.random.default_rng(8).permutation(b)
    (s1, i1), _ = _dense_on_card(cuda_device, key_dtype, q, keys, mask, k)
    (s2, i2), _ = _dense_on_card(cuda_device, key_dtype,
                                 np.ascontiguousarray(q[perm]), keys,
                                 np.ascontiguousarray(mask[perm]), k)
    back = torch.from_numpy(np.argsort(perm))
    assert torch.equal(s1.cpu().view(torch.int32),
                       s2.cpu()[back].view(torch.int32))
    assert torch.equal(i1.cpu(), i2.cpu()[back])


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("b", [1, 37, 128])
def test_cuda_dense_equals_interval_bit_for_bit(cuda_device, b, quant):
    """At a mask that is one interval a row (and the shared ``valid``), the
    dense and interval searches agree bit for bit: the same sums in the same
    order."""
    q, keys, valid, starts, sizes = make_layout_inputs(b, 4096, 64, 4,
                                                       seed=b + 3)
    dev = cuda_device
    kt = torch.from_numpy(keys).to(dev)
    slab = kmod.quantize_keys(kt) if quant else (kt,)
    prefix = "quant_" if quant else ""
    qt, vt, st, sz = (torch.from_numpy(x).to(dev)
                      for x in (q, valid, starts, sizes))
    mask = tref.interval_mask(st, sz, 4096) & vt[None, :]
    ds, di = getattr(kmod, f"{prefix}cosine_topk_masked_cuda")(qt, *slab,
                                                               mask, 4)
    its, iti = getattr(kmod, f"{prefix}cosine_topk_interval_cuda")(
        qt, *slab, vt, st, sz, 4)
    assert torch.equal(ds.view(torch.int32), its.view(torch.int32))
    assert torch.equal(di, iti)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(1, 1), (3, 127), (5, 128), (7, 129),
                                 (37, 4133), (4, 4096 * 3 + 16),
                                 (128, 65536), (600, 1000)])
def test_cuda_tile_summary_matches_plain_version(cuda_device, b, n):
    """Pass 0 (bitmaps, sort keys, tiles seen) equals its plain version,
    with an all-False row and a row whose only visible slot is the last, and
    the rows' ranking a stable sort of the keys (600 rows: three blocks,
    with ties)."""
    rng = np.random.default_rng(n)
    mask = rng.random((b, n)) < 0.002
    mask[0] = False
    if b > 1:
        mask[1] = False
        mask[1, -1] = True
    mt = torch.from_numpy(mask).to(cuda_device)
    *got, order = kmod.tile_summary(mt)
    want = tref.tile_summary_ref(torch.from_numpy(mask))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    assert order.dtype == torch.int32
    assert torch.equal(order.cpu().long(),
                       torch.sort(want[1], stable=True).indices)


@pytest.mark.cuda
@pytest.mark.parametrize("key_dtype", ["f32", "int8"])
@pytest.mark.parametrize("fused", [True, False])
def test_serve_loop_on_cuda_matches_cpu(cuda_device, key_dtype, fused):
    kw = dict(corpus=30, queries=15, batch=16, fused=fused,
              key_dtype=key_dtype, log=lambda *a: None)
    kmod.reset_launches()
    eng, requests, on_card = serve.run(device=str(cuda_device), **kw)
    # one search a batch
    assert kmod.launches == {**dict.fromkeys(kmod.launches, 0),
                             "cosine_topk": -(-len(requests) // 16)}
    _, _, on_cpu = serve.run(device="cpu", **kw)
    assert [(r.answer, r.cached) for r in on_card] == \
        [(r.answer, r.cached) for r in on_cpu]
    np.testing.assert_allclose([r.score for r in on_card],
                               [r.score for r in on_cpu], rtol=0, atol=1e-5)
    assert any(r.cached for r in on_card)


@pytest.mark.cuda
@pytest.mark.parametrize("key_dtype", ["f32", "int8"])
@pytest.mark.parametrize("fused", [True, False])
def test_tenant_serve_loop_on_cuda_matches_cpu(cuda_device, key_dtype, fused):
    kw = dict(corpus=30, queries=15, batch=16, fused=fused, tenants=3,
              key_dtype=key_dtype, log=lambda *a: None)
    kmod.reset_launches()
    eng, requests, on_card = serve.run(device=str(cuda_device), **kw)
    assert kmod.launches == {**dict.fromkeys(kmod.launches, 0),
                             "cosine_topk_interval": -(-len(requests) // 16)}
    cpu, _, on_cpu = serve.run(device="cpu", **kw)
    assert [(r.answer, r.cached) for r in on_card] == \
        [(r.answer, r.cached) for r in on_cpu]
    np.testing.assert_allclose([r.score for r in on_card],
                               [r.score for r in on_cpu], rtol=0, atol=1e-5)
    assert eng.tenant_stats() == cpu.tenant_stats()
    assert any(r.cached for r in on_card)


@pytest.mark.cuda
@pytest.mark.parametrize("key_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("b,n,m,d,k", IVF_CASES + IVF_CHUNK_CASES)
def test_cuda_ivf_kernel_matches_plain_version(cuda_device, b, n, m, d, k,
                                               key_dtype):
    q, keys, cand, ties = make_ivf_inputs(b, n, m, d, k, key_dtype,
                                          seed=b + n + m)
    args = (torch.from_numpy(q).to(cuda_device),
            keys_to_torch(keys, key_dtype).to(cuda_device),
            torch.from_numpy(cand).to(cuda_device))
    before = kivf.launches["ivf_topk"]
    ks, ki = kivf.ivf_topk_cuda(*args, k)
    assert kivf.launches["ivf_topk"] == before + 1
    rs, ri = tref.ivf_topk_ref(*[a.cpu() for a in args], k)
    # bf16 keys too: kernel and plain version sum the same bf16 numbers
    torch.testing.assert_close(ks.cpu(), rs, rtol=0, atol=1e-5)
    assert torch.equal(ki.cpu(), ri)
    for r, want in ties.items():
        assert ki[r, :len(want)].cpu().tolist() == want


def _grouped_on(device, key_dtype, *case, seed):
    q, keys, cand, probe, buckets, ties = make_grouped_ivf_inputs(
        *case, key_dtype, seed=seed)
    args = (torch.from_numpy(q).to(device),
            keys_to_torch(keys, key_dtype).to(device),
            torch.from_numpy(cand).to(device))
    groups = dict(probe=torch.from_numpy(probe).to(device),
                  buckets=torch.from_numpy(buckets).to(device))
    return args, groups, ties


def _same_bits(a, b):
    return torch.equal(a[0].view(torch.int32), b[0].view(torch.int32)) \
        and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("key_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", GROUPED_CASES)
def test_cuda_grouped_ivf_kernel_matches_plain_version(cuda_device, case,
                                                       key_dtype):
    """The bucket-major form against the plain version (which takes no
    grouping), bit for bit equal to the same kernel without the grouping;
    the planted ties across two buckets go to the lower position."""
    args, groups, ties = _grouped_on(cuda_device, key_dtype, *case,
                                     seed=sum(case))
    k = case[-1]
    before = kivf.launches["ivf_topk"]
    grouped = kivf.ivf_topk_cuda(*args, k, **groups)
    assert kivf.launches["ivf_topk"] == before + 1
    ungrouped = kivf.ivf_topk_cuda(*args, k)
    assert_topk_close(grouped, tref.ivf_topk_ref(
        *[a.cpu() for a in args], k + 1), k, 1e-5)
    assert _same_bits(grouped, ungrouped)
    for r, want in ties.items():
        assert grouped[1][r, :len(want)].cpu().tolist() == want


@pytest.mark.cuda
@pytest.mark.parametrize("key_dtype", ["f32", "int8"])
def test_cuda_grouped_ivf_kernel_takes_a_skewed_table(cuda_device, key_dtype):
    """The serve path's P and cap with one full bucket (1,024 live members)
    that all 128 rows probe: its work spreads over tiles and slices, and
    the result is the plain version's, bit for bit the ungrouped form's."""
    case = (128, 24, 1024, 16, 20000, 384, 4)
    args, groups, ties = _grouped_on(cuda_device, key_dtype, *case, seed=5)
    assert bool((groups["probe"] == 0).any(1).all())
    assert bool((groups["buckets"][0] >= 0).all())
    grouped = kivf.ivf_topk_cuda(*args, 4, **groups)
    assert_topk_close(grouped, tref.ivf_topk_ref(*[a.cpu() for a in args],
                                                 5), 4, 1e-5)
    assert _same_bits(grouped, kivf.ivf_topk_cuda(*args, 4))
    assert grouped[1][0, :2].cpu().tolist() == ties[0]


@pytest.mark.cuda
def test_cuda_grouped_ivf_wrapper_refuses_what_the_kernel_does_not_take(
        cuda_device):
    args, groups, _ = _grouped_on(cuda_device, "f32", *GROUPED_CASES[0],
                                  seed=1)
    before = dict(kivf.launches)
    for bad in (dict(groups, probe=groups["probe"].long()),
                dict(groups, buckets=groups["buckets"][:, :-1]),
                dict(groups, probe=groups["probe"].cpu()),
                dict(probe=groups["probe"])):
        with pytest.raises(ValueError):
            kivf.ivf_topk_cuda(*args, 4, **bad)
    assert kivf.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(128, 16), (16384, 16), (1000, 32)])
def test_cuda_cosine_kernel_takes_the_probe_k(cuda_device, n, k):
    q, keys, valid, _ = make_inputs(128, n, 384, "f32", "random", k, seed=n)
    args = [torch.from_numpy(x).to(cuda_device) for x in (q, keys, valid)]
    ks, ki = kmod.cosine_topk_cuda(*args, k)
    rs1, ri1 = tref.cosine_topk_ref(*[a.cpu() for a in args], k + 1)
    # scores within 1e-5; ids equal wherever a score lies more than ID_GAP
    # from its neighbours: at N=16,384 the tensor-core form's 3xTF32 sums
    # may order two slots closer than that otherwise than the CPU's f32
    # GEMM. The slots that differ are printed (pytest -rP shows them).
    swapped = _hold_to_plain(ks, ki, rs1, ri1, k, 1e-5)
    print(f"N={n} k={k}: ids differing (row, place, kernel id, plain id, "
          f"kernel score, plain score, gap): {swapped}")


SMALL_N_CASES = [  # (B, N, k, mask): 4-row query tiles, k past N
    (1, 1, 1, "random"),
    (7, 1, 16, "random"),
    (200, 31, 16, "few"),
    (7, 31, 32, "random"),
    (128, 128, 16, "random"),   # the IVF probe: one chunk, no merge
    (200, 129, 32, "random"),
    (1, 1000, 32, "few"),
    (200, 1000, 1, "random"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("key_dtype", ["f32", "int8"])
@pytest.mark.parametrize("b,n,k,mask", SMALL_N_CASES)
def test_cuda_cosine_kernel_small_n(cuda_device, b, n, k, mask, key_dtype):
    """Small slabs take 4-row query tiles; past N the kernel's entries are
    (-inf, -1), where the plain version stops at min(k, N) entries. The
    plain version runs on the card too: on the CPU a one-row product (a
    GEMV) rounds the last key rows differently, so planted equal rows do
    not tie there."""
    q, keys, valid, ties = make_inputs(b, n, 384, key_dtype, mask, k,
                                       seed=b + n + k)
    args = (torch.from_numpy(q).to(cuda_device),
            keys_to_torch(keys, key_dtype).to(cuda_device),
            torch.from_numpy(valid).to(cuda_device))
    before = kmod.launches["cosine_topk"]
    ks, ki = kmod.cosine_topk_cuda(*args, k)
    assert kmod.launches["cosine_topk"] == before + 1
    assert ks.shape == ki.shape == (b, k)
    rs, ri = tref.cosine_topk_ref(*args, k)
    m = rs.shape[1]
    torch.testing.assert_close(ks[:, :m], rs, rtol=0, atol=1e-5)
    assert torch.equal(ki[:, :m], ri)
    assert bool(torch.all(ki[:, m:] == -1))
    assert bool(torch.all(torch.isneginf(ks[:, m:])))
    want = sorted(set(ties.tolist()))[:k]   # planted equal rows, lowest first
    assert ki[0, :len(want)].cpu().tolist() == want


@pytest.mark.cuda
def test_cuda_ivf_probe_over_the_limit_raises(cuda_device):
    idx = IVFIndex(ncentroids=64, nprobe=kmod.MAX_K + 1, bucket_cap=4)
    st = idx.init(CacheConfig(dim=16, capacity=64), cuda_device)
    q = torch.ones((2, 16), device=cuda_device)
    with pytest.raises(ValueError, match=f"MAX_K={kmod.MAX_K}"):
        idx.candidates(st, q, torch.ones(64, dtype=torch.bool,
                                         device=cuda_device))


def _ivf_engine(device, tmp_path=None, **kw):
    """The warmed IVF serve engine after the refit its first batch would
    run (saved to ``tmp_path`` when given), and its requests."""
    eng, requests = serve.build(device=device, index="ivf",
                                log=lambda *a: None, **kw)
    eng._maybe_refit()
    if tmp_path is not None:
        eng.save_cache(str(tmp_path / "refit"))
    return eng, requests


def _served(responses):
    return ([(r.answer, r.cached) for r in responses],
            np.array([r.score for r in responses]))


@pytest.mark.cuda
@pytest.mark.parametrize("key_dtype", ["f32", "int8"])
def test_ivf_serve_loop_on_cuda_matches_cpu(cuda_device, key_dtype,
                                            tmp_path):
    """One probe and one IVF launch a batch. The card's decisions equal
    those of a CPU engine serving from the card's own post-refit snapshot,
    and those of an independent CPU run whenever the two k-means runs give
    equal bucket tables (an f32 near-tie of two centroids may place a key
    differently on the two devices)."""
    kw = dict(corpus=30, queries=15, batch=16, key_dtype=key_dtype)
    eng, requests = _ivf_engine(str(cuda_device), tmp_path, **kw)
    card_tables = eng.runtime.index_state.buckets.cpu()
    kmod.reset_launches()
    kivf.reset_launches()
    on_card = _served(eng.process(requests))
    batches = -(-len(requests) // 16)
    assert kmod.launches == {**dict.fromkeys(kmod.launches, 0),
                             "cosine_topk": batches}
    assert kivf.launches == {"ivf_topk": batches}
    assert any(cached for _, cached in on_card[0])
    restored, _ = _ivf_engine("cpu", **kw)
    restored.load_cache(str(tmp_path / "refit"))
    cpu, _ = _ivf_engine("cpu", **kw)
    same_tables = torch.equal(card_tables, cpu.runtime.index_state.buckets)
    for other in (restored, cpu) if same_tables else (restored,):
        decisions, scores = _served(other.process(requests))
        assert on_card[0] == decisions
        np.testing.assert_allclose(on_card[1], scores, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_ivf_tenancy_serve_loop_on_cuda_matches_cpu(cuda_device, tmp_path):
    """``--index ivf --tenants 4`` on the card: one probe and one grouped
    IVF launch a batch, each row seeing only its tenant's members through
    cand; the decisions and per-tenant counters equal those of a CPU engine
    serving from the card's post-refit snapshot."""
    kw = dict(corpus=30, queries=15, batch=16, key_dtype="f32", tenants=4)
    eng, requests = _ivf_engine(str(cuda_device), tmp_path, **kw)
    kmod.reset_launches()
    kivf.reset_launches()
    on_card = _served(eng.process(requests))
    batches = -(-len(requests) // 16)
    assert kmod.launches == {**dict.fromkeys(kmod.launches, 0),
                             "cosine_topk": batches}
    assert kivf.launches == {"ivf_topk": batches}
    restored, _ = _ivf_engine("cpu", **kw)
    restored.load_cache(str(tmp_path / "refit"))
    decisions, scores = _served(restored.process(requests))
    assert on_card[0] == decisions
    np.testing.assert_allclose(on_card[1], scores, rtol=0, atol=1e-5)
    assert eng.tenant_stats() == restored.tenant_stats()
    assert any(cached for _, cached in on_card[0])


# --------------------------------------------------------------------- #
# attention kernels of the model-backed miss path
# --------------------------------------------------------------------- #
# kernel and plain version both take f32 products and sums, in other
# orders: f32 outputs agree to 2e-5; a bf16 output may round the other way
# once, one bf16 ulp (at most 2**-7 of the value)
ATTN_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
            torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-5)}

FLASH_CUDA_CASES = [  # (B, Lq, Lk, H, HKV, D, causal, window)
    (3, 64, 64, 32, 4, 128, True, None),    # the serve path's heads
    (2, 100, 100, 8, 8, 64, True, None),    # ragged tail, G=1
    (1, 256, 256, 8, 2, 64, True, 70),      # window, G=4
    (2, 64, 200, 4, 2, 128, True, None),    # Lk > Lq
    (1, 130, 130, 4, 1, 64, False, None),   # bidirectional, ragged
    (39, 64, 64, 32, 4, 128, True, None),   # the serve shape at B=39
    (3, 200, 200, 16, 2, 128, True, None),  # four KV tiles, ragged tail
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,lq,lk,h,hkv,d,causal,window", FLASH_CUDA_CASES)
def test_cuda_flash_attention_matches_plain_version(cuda_device, b, lq, lk,
                                                    h, hkv, d, causal,
                                                    window, dtype):
    rng = np.random.default_rng(lq + lk + h)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32) * sc).to(dtype).to(cuda_device) for shape, sc in (
        ((b, lq, h, d), 0.3), ((b, lk, hkv, d), 0.3), ((b, lk, hkv, d), 1.0)))
    before = kflash.launches["flash_attention"]
    out = kflash.flash_attention_cuda(q, k, v, causal=causal, window=window)
    assert kflash.launches["flash_attention"] == before + 1
    want = tref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert out.dtype == dtype
    torch.testing.assert_close(out.float().cpu(), want.float().cpu(),
                               **ATTN_TOL[dtype])


FLASH_SINK_CUDA_CASES = [  # (B, Lq, Lk, H, HKV, D, window, n_sink)
    (2, 96, 96, 4, 2, 64, 32, 8),         # n_sink < one 64-key tile
    (1, 300, 300, 5, 1, 64, 48, 100),     # sinks span tiles, G=5
    (1, 130, 130, 6, 1, 128, 40, 200),    # n_sink >= Lk, G=6
    (2, 64, 256, 10, 2, 64, 50, 70),      # Lk > Lq with sinks
    (40, 192, 192, 25, 5, 64, 1024, 128),  # hymba's serve shape
    (2, 2048, 2048, 25, 5, 64, 1024, 128),  # the window drops keys
    (3, 200, 200, 48, 8, 128, 64, 16),    # grok-1's heads, G=6
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,lq,lk,h,hkv,d,window,n_sink",
                         FLASH_SINK_CUDA_CASES)
def test_cuda_flash_attention_with_sinks_matches_plain_version(
        cuda_device, b, lq, lk, h, hkv, d, window, n_sink, dtype):
    """Attention sinks in the hand-written kernel, through ``ops`` as the
    model calls it: one launch, the plain version's output."""
    rng = np.random.default_rng(lq + n_sink + h)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32) * sc).to(dtype).to(cuda_device) for shape, sc in (
        ((b, lq, h, d), 0.3), ((b, lk, hkv, d), 0.3), ((b, lk, hkv, d), 1.0)))
    before = kflash.launches["flash_attention"]
    out = ops.flash_attention(q, k, v, window=window, n_sink=n_sink)
    assert kflash.launches["flash_attention"] == before + 1
    want = tref.flash_attention_ref(q, k, v, window=window, n_sink=n_sink)
    torch.testing.assert_close(out.float().cpu(), want.float().cpu(),
                               **ATTN_TOL[dtype])


DECODE_CUDA_CASES = [  # (B, S, H, HKV, D, window, n_sink, ring)
    (5, 96, 32, 4, 128, None, 0, False),    # the serve path's heads
    (2, 512, 8, 2, 64, None, 0, True),      # a ring with empty slots
    (3, 96, 6, 2, 64, 32, 8, False),        # window with sinks
    (2, 128, 16, 1, 256, None, 0, False),   # G=16, D=256, two splits
    (1, 96, 32, 4, 128, None, 0, False),    # B=1
    (2, 1, 8, 2, 64, None, 0, False),       # S=1
    (3, 17, 8, 2, 64, None, 0, False),      # S=17, one split
    (2, 4096, 32, 4, 128, None, 0, False),  # S=4096, several splits
    (3, 512, 32, 4, 128, None, 0, True),    # whole splits empty: m = -inf
    (1, 1024, 16, 1, 256, 300, 2, True),    # G=16, D=256, split, window
    (1, 20000, 4, 1, 64, None, 0, True),    # 128 splits of two tiles each
    (4, 96, 25, 5, 64, 1024, 128, True),    # hymba's heads and sinks, G=5
    (3, 96, 48, 8, 128, 40, 8, True),       # grok-1's heads, G=6, window
]


def _decode_case(b, s, h, hkv, d, ring, kv, dev, seed):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy((rng.standard_normal((b, 1, h, d)) * 0.3).astype(
        np.float32))
    k = torch.from_numpy((rng.standard_normal((b, s, hkv, d)) * 0.3).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((b, s, hkv, d)).astype(
        np.float32))
    slot_pos = np.arange(s, dtype=np.int32)
    pos = s - 1
    if ring:   # slots [0, s/4) hold the newest positions, [s/2, s) empty
        slot_pos = np.full(s, -1, np.int32)
        slot_pos[:s // 4] = np.arange(s // 4) + s
        slot_pos[s // 4:s // 2] = np.arange(s // 4, s // 2)
        pos = s + s // 4 - 1
    ks = vs = None
    if kv == "int8":
        from repro_torch.models.attention import quantize_kv
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
        ks, vs = ks.to(dev), vs.to(dev)
    elif kv == "bf16":
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    return (q.to(dev), k.to(dev), v.to(dev),
            torch.from_numpy(slot_pos).to(dev), pos, ks, vs)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("b,s,h,hkv,d,window,sink,ring", DECODE_CUDA_CASES)
def test_cuda_decode_attention_matches_plain_version(cuda_device, b, s, h,
                                                     hkv, d, window, sink,
                                                     ring, kv):
    q, k, v, sp, pos, ks, vs = _decode_case(b, s, h, hkv, d, ring, kv,
                                            cuda_device, seed=b * s + h)
    kw = dict(window=window, n_sink=sink, k_scale=ks, v_scale=vs)
    n_split, _ = kdec.split(s, d, k.element_size())
    assert (n_split > 1) == (s >= 2 * kdec.MIN_SLOTS)
    before = kdec.launches["decode_attention"]
    out = kdec.decode_attention_cuda(q, k, v, sp, pos, **kw)
    assert kdec.launches["decode_attention"] == before + 1
    want = tref.decode_attention_ref(q, k, v, sp, pos, **kw)
    torch.testing.assert_close(out.float().cpu(), want.float().cpu(),
                               **ATTN_TOL[q.dtype])
    # nothing visible: every stored position past pos gives exactly 0
    none = kdec.decode_attention_cuda(q, k, v, sp + 10 ** 6, pos, **kw)
    assert bool(torch.all(none == 0))


# the kernel's log-sum-exp against the plain version's, absolute: f32
# exponentials summed in other orders (1e-5); a bf16 cache's scores are the
# tensor cores' sums (1e-4)
DECODE_LSE_TOL = {"f32": 1e-5, "bf16": 1e-4, "int8": 1e-5}


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("b,s,h,hkv,d,window,sink,ring", DECODE_CUDA_CASES)
def test_cuda_decode_lse_matches_plain_version(cuda_device, b, s, h, hkv, d,
                                               window, sink, ring, kv):
    """With ``return_lse`` the kernel writes each row's log-sum-exp (the
    single split's block, or the merge kernel): -inf where the plain
    version's is, within DECODE_LSE_TOL elsewhere; the output beside it is
    the output without it, bit for bit."""
    q, k, v, sp, pos, ks, vs = _decode_case(b, s, h, hkv, d, ring, kv,
                                            cuda_device, seed=b * s + h)
    kw = dict(window=window, n_sink=sink, k_scale=ks, v_scale=vs)
    out = kdec.decode_attention_cuda(q, k, v, sp, pos, **kw)
    got, lse = kdec.decode_attention_cuda(q, k, v, sp, pos, return_lse=True,
                                          **kw)
    _, want = tref.decode_attention_ref(q, k, v, sp, pos, return_lse=True,
                                        **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, out)
    assert lse.dtype == torch.float32 and lse.shape == (b, h)
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(lse), inf) and not lse.isnan().any()
    if bool((~inf).any()):
        assert float((lse[~inf] - want[~inf]).abs().max()) <= \
            DECODE_LSE_TOL[kv]
    _, none = kdec.decode_attention_cuda(q, k, v, sp + 10 ** 6, pos,
                                         return_lse=True, **kw)
    assert bool(torch.isneginf(none).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("b,s,ring", [(39, 96, False), (8, 4096, False),
                                      (3, 512, True)])
def test_cuda_decode_split_merge_equals_whole_call(cuda_device, b, s, ring,
                                                   kv):
    """The cache cut into 2 and 4 slot ranges, as context-parallel decode
    cuts it over ``model``: each range through the kernel with its lse,
    merged by ``merge_lse``, equals the whole call (f32 and int8 within
    ATTN_TOL; bf16 parts are rounded before the merge: two ulps)."""
    from repro_torch.models.attention import merge_lse
    q, k, v, sp, pos, ks, vs = _decode_case(b, s, 32, 4, 128, ring, kv,
                                            cuda_device, seed=b + s)
    whole = ops.decode_attention(q, k, v, sp, pos, k_scale=ks, v_scale=vs)
    tol = dict(rtol=2.0 ** -6, atol=2.0 ** -8) if kv == "bf16" else \
        ATTN_TOL[torch.float32]
    for n in (2, 4):
        cuts = [i * s // n for i in range(n + 1)]
        parts = []
        for lo, hi in zip(cuts, cuts[1:]):
            def cut(x):
                return None if x is None else x[:, lo:hi].contiguous()
            parts.append(ops.decode_attention(
                q, cut(k), cut(v), sp[lo:hi].contiguous(), pos,
                k_scale=cut(ks), v_scale=cut(vs), return_lse=True))
        got = merge_lse(torch.stack([o for o, _ in parts]),
                        torch.stack([x for _, x in parts]),
                        lambda x, op: x.amax(0) if op == "max" else x.sum(0))
        assert got.dtype == whole.dtype
        torch.testing.assert_close(got.float().cpu(), whole.float().cpu(),
                                   **tol)


@pytest.mark.cuda
def test_cuda_attention_wrappers_refuse(cuda_device):
    dev = cuda_device
    q = torch.zeros((1, 8, 4, 48), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        kflash.flash_attention_cuda(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros((1, 8, 4, 64), device=dev)
    kv = torch.zeros((1, 8, 2, 64), device=dev)
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        kflash.flash_attention_cuda(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="contiguous"):
        kflash.flash_attention_cuda(q.transpose(1, 2).contiguous()
                                    .transpose(1, 2), kv, kv)
    with pytest.raises(ValueError, match="n_sink"):
        ops.flash_attention(q, kv, kv, window=4, n_sink=-1)
    q1 = torch.zeros((1, 1, 34, 64), device=dev)
    c = torch.zeros((1, 8, 2, 64), device=dev)
    sp = torch.arange(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="H/HKV"):
        kdec.decode_attention_cuda(q1, c, c, sp, 7)
    q1 = torch.zeros((1, 1, 4, 64), device=dev)
    with pytest.raises(ValueError, match="int8 caches need"):
        kdec.decode_attention_cuda(q1, c.to(torch.int8), c.to(torch.int8),
                                   sp, 7)
    with pytest.raises(ValueError, match="one device"):
        kdec.decode_attention_cuda(q1, c, c, sp.cpu(), 7)


def _yi_reduced(device, state=None):
    m = Model(get_arch("yi-6b").reduced(), device=device)
    if state is None:
        return m.init_params(prng.key(0))
    m.load_state_dict(state)
    return m


@pytest.mark.cuda
def test_model_backend_launches_and_answers_on_cuda(cuda_device):
    """One generate of the reduced yi-6b: two prefills of 2 layers (4 flash
    launches) and 23 decode steps of 2 layers (46 decode launches); its
    logits and answers equal those of the same weights on the CPU."""
    card = _yi_reduced(cuda_device)
    cpu = _yi_reduced("cpu", {n: t.cpu() for n, t in
                              card.state_dict().items()})
    queries = ["how do I reset my router", "what is a python list",
               "where is my order"]
    kflash.reset_launches()
    kdec.reset_launches()
    res = ModelBackend(card, HashTokenizer(vocab_size=1024)).generate(queries)
    assert kflash.launches["flash_attention"] == 2 * 2
    assert kdec.launches["decode_attention"] == 23 * 2
    want = ModelBackend(cpu, HashTokenizer(vocab_size=1024)).generate(queries)
    assert res.answers == want.answers
    toks = torch.randint(0, 1024, (3, 64), generator=torch.Generator()
                         .manual_seed(1))
    with torch.inference_mode():
        lg, caches = card(toks.to(cuda_device), collect_cache=True,
                          cache_size=96)
        lc, cc = cpu(toks, collect_cache=True, cache_size=96)
        torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=1e-4)
        nt = lc[:, -1:].argmax(-1)
        dg, _ = card.decode_step(caches, nt.to(cuda_device))
        dc, _ = cpu.decode_step(cc, nt)
        torch.testing.assert_close(dg.cpu(), dc, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["grok-1-314b", "llama4-maverick-400b-a17b",
                                  "mamba2-130m", "hymba-1.5b"])
def test_model_families_on_cuda_match_cpu(cuda_device, arch):
    """One generate of each reduced family (f32) on the card: two prefills
    and 23 decode steps of each attention layer through the kernels (none
    for mamba2), the MoE and SSM layers in PyTorch; logits, SSM states and
    answers equal to the same weights on the CPU."""
    cfg = get_arch(arch).reduced()
    card = Model(cfg, device=cuda_device).init_params(prng.key(0))
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({n: t.cpu() for n, t in card.state_dict().items()})
    queries = ["how do I reset my router", "what is a python list",
               "where is my order"]
    kflash.reset_launches()
    kdec.reset_launches()
    res = ModelBackend(card, HashTokenizer(vocab_size=1024)).generate(queries)
    layers = cfg.n_layers if cfg.has_attention else 0
    assert kflash.launches["flash_attention"] == 2 * layers
    assert kdec.launches["decode_attention"] == 23 * layers
    want = ModelBackend(cpu, HashTokenizer(vocab_size=1024)).generate(queries)
    assert res.answers == want.answers
    toks = torch.randint(0, 1024, (3, 64), generator=torch.Generator()
                         .manual_seed(1))
    with torch.inference_mode():
        lg, cg = card(toks.to(cuda_device), collect_cache=True, cache_size=80)
        lc, cc = cpu(toks, collect_cache=True, cache_size=80)
        torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=1e-4)
        nt = lc[:, -1:].argmax(-1)
        for _ in range(3):
            dg, cg = card.decode_step(cg, nt.to(cuda_device))
            dc, cc = cpu.decode_step(cc, nt)
            torch.testing.assert_close(dg.cpu(), dc, rtol=0, atol=1e-4)
            nt = dc.argmax(-1)
        if cfg.has_ssm:
            torch.testing.assert_close(cg.ssm.ssd.cpu(), cc.ssm.ssd,
                                       rtol=1e-5, atol=1e-4)


def _waves(eng, requests, batch):
    async def drive():
        sched = SchedulerConfig(max_batch=batch, max_wait_ms=50.0,
                                coalesce=False)
        async with AsyncCacheServer(eng, sched) as server:
            return await run_waves(server.submit_request, requests,
                                   wave=batch)
    return asyncio.run(drive()).responses


@pytest.mark.cuda
@pytest.mark.parametrize("tenants", [0, 3])
def test_async_waves_on_cuda_match_sync_and_cpu(cuda_device, tenants):
    """Lockstep waves through the scheduler (its single worker thread
    launches the kernels): one launch a wave, and the sync card run's and
    the CPU waves' decisions, answers, counters."""
    kw = dict(corpus=30, queries=15, batch=16, tenants=tenants,
              log=lambda *a: None)
    name = "cosine_topk_interval" if tenants else "cosine_topk"
    runs = {}
    for device in (str(cuda_device), "cpu"):
        eng, requests = serve.build(device=device, **kw)
        kmod.reset_launches()
        runs[device] = (eng, _waves(eng, requests, 16))
        if device != "cpu":
            assert kmod.launches == {**dict.fromkeys(kmod.launches, 0),
                                     name: -(-len(requests) // 16)}
    _, _, sync = serve.run(device=str(cuda_device), **kw)
    (card, on_card), (cpu, on_cpu) = runs[str(cuda_device)], runs["cpu"]
    for other in (sync, on_cpu):
        assert [(r.answer, r.cached) for r in on_card] == \
            [(r.answer, r.cached) for r in other]
        np.testing.assert_allclose([r.score for r in on_card],
                                   [r.score for r in other], rtol=0,
                                   atol=1e-5)
    assert card.stats.host() == cpu.stats.host()
    assert card.tenant_stats() == cpu.tenant_stats()
    assert card.backend.calls == cpu.backend.calls


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_tracing_engine_on_cuda(cuda_device, fused):
    """Each device span ends with the host read that waits for its work:
    the spans tile the batch's wall time and equal the CPU run's names."""
    kw = dict(corpus=30, queries=15, batch=16, fused=fused,
              log=lambda *a: None)
    traces = {}
    for device in (str(cuda_device), "cpu"):
        tracer = Tracer(TraceConfig(sample_rate=1.0, head=0))
        eng, requests = serve.build(device=device, tracer=tracer, **kw)
        eng.process(requests)
        traces[device] = tracer.traces()
        assert len(traces[device]) == len(requests)
    for a, b in zip(traces[str(cuda_device)], traces["cpu"]):
        assert [s.name for s in a.spans] == [s.name for s in b.spans]
        assert a.meta == b.meta
        assert a.span_sum_s == pytest.approx(a.e2e_s, rel=1e-9)
        assert a.stage_seconds()["device_step"] > 0


def _feature_run(device, *, fusion=None, synthesizer=None, policy=None,
                 resilience=None, schedule=None, n=40, batch=8):
    """A small engine with one of this slice's features: record/replay
    conversations (fusion), or a paraphrase-heavy stream; returns the
    engine, its responses and the cosine kernel's launches."""
    from repro_torch.data.qa_dataset import build_corpus
    from repro_torch.serving import (CachedEngine, FaultyBackend, Request,
                                     SimulatedLLMBackend,
                                     build_multi_turn_workload,
                                     build_workload, turn_levels)
    pairs = build_corpus(n, seed=0)
    convs = build_multi_turn_workload(pairs, 6, turns=3, seed=23)
    key_by_sid = {p.qa_id: p.semantic_key for p in pairs}
    for conv in convs:
        for r in conv:
            key_by_sid.setdefault(r.source_id, r.semantic_key)

    def judge(req, sid):
        return key_by_sid.get(sid, "") == req.semantic_key

    backend = SimulatedLLMBackend(pairs)
    if schedule is not None:
        backend = FaultyBackend(backend, schedule)
    eng = CachedEngine(CacheConfig(dim=384, capacity=8 * n, value_len=48),
                       backend, judge=judge, batch_size=batch, fusion=fusion,
                       synthesizer=synthesizer, policy=policy,
                       resilience=resilience, device=device)
    eng.warm(pairs)
    kmod.reset_launches()
    batches = []
    if fusion is not None:
        for part in (convs[:6], convs[6:]):
            batches += turn_levels(part)
    reqs = build_workload(pairs, 6 * batch, paraphrase_ratio=0.9, seed=43)
    batches += [reqs[i:i + batch] for i in range(0, len(reqs), batch)]
    resp = []
    for b in batches:
        resp += eng.process(b)
    return eng, resp, dict(kmod.launches), len(batches)


def _same_on_card_and_cpu(card, cpu):
    (ceng, cresp, launches, nb), (peng, presp, _, _) = card, cpu
    assert launches == {**dict.fromkeys(launches, 0), "cosine_topk": nb}
    assert [(r.answer, r.cached, r.context, r.near_hit, r.degraded, r.error)
            for r in cresp] == \
        [(r.answer, r.cached, r.context, r.near_hit, r.degraded, r.error)
         for r in presp]
    np.testing.assert_allclose([r.score for r in cresp],
                               [r.score for r in presp], rtol=0, atol=1e-5)
    assert ceng.stats.host() == peng.stats.host()
    assert ceng.metrics.summary()["categories"] == \
        peng.metrics.summary()["categories"]


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["decay", "attention"])
def test_sessions_on_cuda_match_cpu(cuda_device, strategy):
    """Fused keys on the card within 1e-5 of the CPU's (the session rings
    hold them), the same decisions, and the replays' follow-ups hit."""
    from repro_torch.context import AttentionFusion, DecayMeanFusion
    make = DecayMeanFusion if strategy == "decay" else AttentionFusion
    card = _feature_run(str(cuda_device), fusion=make(window=4))
    cpu = _feature_run("cpu", fusion=make(window=4))
    _same_on_card_and_cpu(card, cpu)
    ceng, peng = card[0], cpu[0]
    assert ceng.runtime.fusion.context_weight.device.type == "cuda"
    for key, s in ceng.sessions._sessions.items():
        np.testing.assert_allclose(s.ring, peng.sessions._sessions[key].ring,
                                   rtol=0, atol=1e-5)
    rep = ceng.metrics.summary()["categories"]["ctx/followup_repeat"]
    assert rep["cache_hits"] >= 10


@pytest.mark.cuda
def test_near_hit_band_on_cuda_matches_cpu(cuda_device):
    from repro_torch.generative import BandPolicy, TemplateSplice
    kw = dict(synthesizer=TemplateSplice(rival_margin=0.12),
              policy=BandPolicy(tau_lo=0.75, tau_hi=0.8))
    card = _feature_run(str(cuda_device), **kw)
    cpu = _feature_run("cpu", **kw)
    _same_on_card_and_cpu(card, cpu)
    assert card[0].metrics.summary()["near"] == \
        cpu[0].metrics.summary()["near"]
    np.testing.assert_allclose(card[0].policy_state.cpu().numpy(),
                               cpu[0].policy_state.numpy(), rtol=0,
                               atol=1e-6)


@pytest.mark.cuda
def test_resilience_on_cuda_matches_cpu(cuda_device):
    from repro_torch.generative import BandPolicy
    from repro_torch.serving import (CircuitBreaker, FaultSchedule,
                                     FaultWindow, ResilienceConfig,
                                     RetryPolicy)
    runs = []
    for device in (str(cuda_device), "cpu"):
        res = ResilienceConfig(
            retry=RetryPolicy(max_attempts=3, base_backoff_s=0.001,
                              max_backoff_s=0.002, seed=3),
            breaker=CircuitBreaker(failure_threshold=3, window=8,
                                   cooldown_s=0.0),
            sleep=lambda s: None)
        sched = FaultSchedule([FaultWindow("error", 1, 4),
                               FaultWindow("brownout", 4, 6,
                                           error_rate=0.5)], seed=5)
        runs.append(_feature_run(device, resilience=res, schedule=sched,
                                 policy=BandPolicy(0.70, 0.80,
                                                   degraded_lo=0.60)))
    _same_on_card_and_cpu(*runs)
    assert runs[0][0].metrics.summary()["resilience"] == \
        runs[1][0].metrics.summary()["resilience"]
    assert any(r.degraded or r.error for r in runs[0][1])


# --------------------------------------------------------------------- #
# the sharded cache: four shards on the one card
# --------------------------------------------------------------------- #
def _sharded_kw(**kw):
    return dict(corpus=30, queries=15, batch=16, log=lambda *a: None, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("key_dtype", ["f32", "int8"])
def test_sharded_serve_loop_on_cuda_matches_unsharded_and_cpu(cuda_device,
                                                              key_dtype):
    """``--shards 4`` on the card: four cosine launches a batch, one per
    shard over N/4 slots; the decisions, answers and scores (within 1e-5)
    equal the unsharded card run's and the sharded CPU run's, every shard
    holds a quarter of the entries, and the slab holds the unsharded card
    slab's keys bit for bit."""
    kw = _sharded_kw(key_dtype=key_dtype)
    kmod.reset_launches()
    eng, reqs, resp = serve.run(device="cuda", shards=4, **kw)
    batches = -(-len(reqs) // 16)
    assert kmod.launches == {**dict.fromkeys(kmod.launches, 0),
                             "cosine_topk": 4 * batches}
    base = _served(resp)
    assert any(cached for _, cached in base[0])
    others = {}
    for device, shards in (("cuda", 0), ("cpu", 4)):
        other, _, oresp = serve.run(device=device, shards=shards, **kw)
        decisions, scores = _served(oresp)
        assert base[0] == decisions, (device, shards)
        np.testing.assert_allclose(base[1], scores, rtol=0, atol=1e-5)
        assert eng.stats.host() == other.stats.host()
        others[device] = other
    st = eng.state
    n = int(st.valid.sum())
    per_shard = st.valid.reshape(4, -1).sum(1).tolist()
    assert all(x in (n // 4, -(-n // 4)) for x in per_shard), per_shard
    keys = sorted(r.tobytes() for r in st.keys[st.valid].cpu().numpy())
    ost = others["cuda"].state
    assert keys == sorted(r.tobytes()
                          for r in ost.keys[ost.valid].cpu().numpy())


MIXED = ["cuda:0", "cpu", "cuda:0", "cpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("key_dtype", ["f32", "int8"])
def test_sharded_serve_loop_over_mixed_devices_matches_one_device(
        cuda_device, key_dtype, tmp_path):
    """``--shards cuda:0,cpu,cuda:0,cpu``: shards 0 and 2 on the card,
    1 and 3 on the CPU, the engine on the card. Each shard's state stays on
    its device; the decisions, answers, scores (within 1e-5), counters and
    slab, slot by slot (keys within 1e-6, or an int8 step), equal the
    one-device 4-shard run's; its snapshot restores
    into one card engine of 4 shards and into an unsharded one."""
    kw = _sharded_kw(key_dtype=key_dtype)
    one, reqs, want = serve.run(device="cuda", shards=4, **kw)
    kmod.reset_launches()
    mixed, _, got = serve.run(device="cuda", shards=MIXED, **kw)
    batches = -(-len(reqs) // 16)
    # the CPU shards run the plain version: two launches a batch
    assert kmod.launches["cosine_topk"] == 2 * batches
    assert mixed.device.type == "cuda"
    for shard, dev in zip(mixed.runtime.shards, MIXED):
        for leaf in (shard.state.keys, shard.state.valid, shard.stats.hits):
            assert leaf.device.type == torch.device(dev).type
    assert _served(got)[0] == _served(want)[0]
    np.testing.assert_allclose(_served(got)[1], _served(want)[1], rtol=0,
                               atol=1e-5)
    assert mixed.stats.host() == one.stats.host()
    # the same layout, slot by slot; a CPU shard's keys were normalized
    # there (the norm's sum in another order: last bits; int8 may round
    # to the next step)
    st, ost = mixed.state, one.state
    for name in ("valid", "values", "source_id", "freq", "n_inserts"):
        assert torch.equal(getattr(st, name), getattr(ost, name)), name
    tol = 1.0 if key_dtype == "int8" else 1e-6
    assert float((st.keys.float() - ost.keys.float()).abs().max()) <= tol
    mixed.save_cache(str(tmp_path / "mixed"))
    follow = _served(mixed.process(reqs))[0]
    for shards in (4, 0):
        back, _ = serve.build(device="cuda", shards=shards, **kw)
        back.tokenizer = mixed.tokenizer
        back.load_cache(str(tmp_path / "mixed"))
        assert _served(back.process(reqs))[0] == follow


@pytest.mark.cuda
def test_sharded_ivf_on_cuda_matches_restored_cpu(cuda_device, tmp_path):
    """``--shards 4 --index ivf``: per batch four probes and four IVF
    launches, one per shard's own index; the decisions equal those of a
    sharded CPU engine serving from the card's post-refit snapshot."""
    kw = dict(corpus=30, queries=15, batch=16, key_dtype="f32", shards=4)
    eng, requests = _ivf_engine(str(cuda_device), tmp_path, **kw)
    assert tuple(eng.runtime.index_state.buckets.shape) == (4 * 128, 1024)
    kmod.reset_launches()
    kivf.reset_launches()
    on_card = _served(eng.process(requests))
    batches = -(-len(requests) // 16)
    assert kmod.launches == {**dict.fromkeys(kmod.launches, 0),
                             "cosine_topk": 4 * batches}
    assert kivf.launches == {"ivf_topk": 4 * batches}
    restored, _ = _ivf_engine("cpu", **kw)
    restored.load_cache(str(tmp_path / "refit"))
    decisions, scores = _served(restored.process(requests))
    assert on_card[0] == decisions
    np.testing.assert_allclose(on_card[1], scores, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_reshard_on_cuda(cuda_device, tmp_path):
    """An unsharded card engine's snapshot: a strict load into four shards
    is refused; resharded, every shard holds entries and the same requests
    get the unsharded engine's decisions; and 4 -> 1 back."""
    kw = _sharded_kw(key_dtype="f32")
    one, reqs, _ = serve.run(device="cuda", **kw)
    one.save_cache(str(tmp_path / "one"))
    want = _served(one.process(reqs))
    four, _ = serve.build(device="cuda", shards=4, **kw)
    # the tokenizer's vocabulary is host state a snapshot does not carry:
    # share it, so that restored answers decode to the same words
    four.tokenizer = one.tokenizer
    with pytest.raises(ValueError, match="shard"):
        four.load_cache(str(tmp_path / "one"), reshard=False)
    four.load_cache(str(tmp_path / "one"))
    assert bool((four.state.valid.reshape(4, -1).sum(1) > 0).all())
    got = _served(four.process(reqs))
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    four.save_cache(str(tmp_path / "four"))
    back, _ = serve.build(device="cuda", **kw)
    back.tokenizer = one.tokenizer
    back.load_cache(str(tmp_path / "four"))
    # both hold the entries of two passes now
    assert _served(back.process(reqs))[0] == _served(one.process(reqs))[0]


# --------------------------------------------------------------------- #
# training on the card: the flash-attention backward (row 9b), the
# audio and vlm families, a training step through the kernels
# --------------------------------------------------------------------- #
FLASH_BWD_CUDA_CASES = [  # (B, Lq, Lk, H, HKV, D, causal, window, n_sink)
    (2, 100, 100, 4, 4, 64, True, None, 0),      # G=1, ragged
    (1, 256, 256, 10, 2, 64, True, 70, 0),       # G=5, window drops keys
    (1, 300, 300, 12, 2, 128, True, 50, 128),    # G=6, sinks span tiles
    (2, 64, 200, 6, 1, 128, True, 90, 70),       # Lk > Lq with sinks
    (1, 100, 60, 4, 2, 64, True, None, 0),       # 40 rows see nothing
    (2, 96, 96, 4, 2, 64, False, None, 0),       # not causal
    (8, 128, 128, 12, 2, 128, True, None, 0),    # qwen2-vl's step: 5 slices
    (3, 200, 200, 12, 2, 128, True, 90, 70),     # sliced, with sinks
    (4, 192, 192, 32, 32, 64, True, None, 0),    # musicgen's step: one slice
]
# of the largest |gradient|: f32 sums in another order; bf16 gradients
# rounded once from f32 sums of bf16 operands
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def test_flash_bwd_card_cases_take_both_ways_of_writing_dk_dv():
    """On an H100's 132 SMs the card cases of the backward take one slice
    (dK and dV written by their block) and several (f32 partials summed by
    a last launch), so both ways of writing them are held to the plain
    version."""
    splits = {kflash.bwd_plan(*case[:6], 132).splits
              for case in FLASH_BWD_CUDA_CASES}
    assert 1 in splits and max(splits) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,lq,lk,h,hkv,d,causal,window,n_sink",
                         FLASH_BWD_CUDA_CASES)
def test_cuda_flash_attention_backward_matches_plain_version(
        cuda_device, b, lq, lk, h, hkv, d, causal, window, n_sink, dtype):
    """``ops.flash_attention`` with operands that require grad: an output
    with a grad_fn, one forward launch (with the log-sum-exp) and one
    backward call of the hand-written kernel; dq, dk, dv in the operands'
    dtype, within ``BWD_TOL`` of the plain backward in f32 of the same
    operands, the same bits in a second run, zero for rows that see no
    key."""
    rng = np.random.default_rng(lq + lk + h + n_sink)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32) * sc).to(dtype).to(cuda_device) for shape, sc in (
        ((b, lq, h, d), 0.3), ((b, lk, hkv, d), 0.3), ((b, lk, hkv, d), 1.0),
        ((b, lq, h, d), 1.0)))
    kw = dict(causal=causal, window=window, n_sink=n_sink)
    kflash.reset_launches()
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, **kw)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, g)
    assert kflash.launches == {"flash_attention": 1,
                               "flash_attention_bwd": 1}
    _, lse = tref.flash_attention_lse_ref(q.float(), k.float(), v.float(),
                                          **kw)
    want = tref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                        out.detach().float(), g.float(), lse,
                                        **kw)
    again = torch.autograd.grad(ops.flash_attention(*leaves, **kw), leaves, g)
    for x, y, w in zip(got, again, want):
        assert x.dtype == dtype and torch.equal(x, y)
        err = float((x.float() - w).abs().max())
        assert err <= BWD_TOL[dtype] * float(w.abs().max())
    if lk < lq:   # rows before the keys' positions see nothing
        assert float(got[0][:, :lq - lk].float().abs().max()) == 0.0
    with pytest.raises(RuntimeError, match="autograd"):
        kflash.flash_attention_cuda(*leaves, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["yi-6b", "llama4-maverick-400b-a17b",
                                  "hymba-1.5b", "musicgen-large",
                                  "qwen2-vl-2b"])
def test_training_step_through_the_kernels_matches_cpu(cuda_device, arch):
    """The reduced model's ``loss_fn`` and every parameter's gradient on
    the card (flash forward and backward kernels) against the same weights
    on the CPU (the plain versions through the same autograd Function);
    ``wq``'s gradient is not zero, and the backward kernel ran once a
    layer."""
    cfg = get_arch(arch).reduced()
    card = Model(cfg, device=cuda_device).init_params(prng.key(0))
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({n: t.cpu() for n, t in card.state_dict().items()})
    rng = np.random.default_rng(3)
    books = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40) + books))
    prefix = torch.from_numpy(rng.standard_normal(
        (2, cfg.n_prefix, cfg.d_model)).astype(np.float32)) \
        if cfg.n_prefix else None
    losses, grads = [], []
    kflash.reset_launches()
    for m, dev in ((card, cuda_device), (cpu, "cpu")):
        m.requires_grad_(True)
        loss = m.loss_fn(toks.to(dev), prefix_emb=None if prefix is None
                         else prefix.to(dev))
        loss.backward()
        losses.append(float(loss))
        grads.append({n: p.grad.cpu() for n, p in m.named_parameters()})
    assert kflash.launches["flash_attention_bwd"] == cfg.n_layers
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1])
    assert float(grads[0]["blocks.wq"].abs().max()) > 0
    for name, want in grads[1].items():
        err = float((grads[0][name] - want).abs().max())
        assert err <= 1e-3 * max(float(want.abs().max()), 1e-6), name


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["musicgen-large", "qwen2-vl-2b"])
def test_audio_and_vlm_on_cuda_match_cpu(cuda_device, arch):
    """The reduced audio and vlm models (f32) behind their prefix: prefill
    through the flash kernel and three decode steps through the decode
    kernel, logits and caches equal to the same weights on the CPU."""
    cfg = get_arch(arch).reduced()
    card = Model(cfg, device=cuda_device).init_params(prng.key(0))
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({n: t.cpu() for n, t in card.state_dict().items()})
    rng = np.random.default_rng(5)
    books = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 24) + books))
    prefix = torch.from_numpy(rng.standard_normal(
        (3, cfg.n_prefix, cfg.d_model)).astype(np.float32))
    kflash.reset_launches()
    kdec.reset_launches()
    with torch.inference_mode():
        lg, cg = card(toks.to(cuda_device), prefix_emb=prefix.to(cuda_device),
                      collect_cache=True, cache_size=64)
        lc, cc = cpu(toks, prefix_emb=prefix, collect_cache=True,
                     cache_size=64)
        torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=1e-4)
        torch.testing.assert_close(cg.kv.k.cpu(), cc.kv.k, rtol=0, atol=1e-4)
        nt = lc[:, -1:].argmax(-1)
        for _ in range(3):
            dg, cg = card.decode_step(cg, nt.to(cuda_device))
            dc, cc = cpu.decode_step(cc, nt)
            torch.testing.assert_close(dg.cpu(), dc, rtol=0, atol=1e-4)
            nt = dc.argmax(-1)
    assert kflash.launches["flash_attention"] == cfg.n_layers
    assert kdec.launches["decode_attention"] == 3 * cfg.n_layers


@pytest.mark.cuda
def test_train_driver_on_cuda_matches_cpu(cuda_device):
    """``launch.train`` on the reduced deepseek-7b: three AdamW steps on
    the card from the CPU run's initial weights, losses and gradient norms
    within 1e-4 of the CPU's, through the backward kernel."""
    from repro_torch.launch import train as tr
    init = Model(get_arch("deepseek-7b").reduced(),
                 device="cpu").init_params(prng.key(0)).state_dict()
    kflash.reset_launches()
    card = tr.train(steps=3, batch=2, seq=32, device="cuda", params=init,
                    log=lambda *a: None)
    assert kflash.launches["flash_attention_bwd"] == 3 * 2
    cpu = tr.train(steps=3, batch=2, seq=32, device="cpu", params=init,
                   log=lambda *a: None)
    np.testing.assert_allclose(card["loss"], cpu["loss"], rtol=1e-4)
    np.testing.assert_allclose(card["grad_norm"], cpu["grad_norm"], rtol=1e-4)


@pytest.mark.cuda
def test_encoder_on_cuda_matches_cpu(cuda_device):
    """MiniLM at full width, the same weights on the card and the CPU,
    ragged lengths with rows of length 1 and 0: within 1e-5 (f32, TF32
    off)."""
    from repro_torch.embedding import MINILM_L6, encode, init_encoder_params
    params = init_encoder_params(prng.key(0), device="cpu")
    card = {k: ({n: t.to(cuda_device) for n, t in v.items()}
                if isinstance(v, dict) else v.to(cuda_device))
            for k, v in params.items()}
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, MINILM_L6.vocab, (5, 24)))
    lens = torch.tensor([24, 9, 1, 0, 13])
    want = encode(params, tokens, lens)
    got = encode(card, tokens.to(cuda_device), lens.to(cuda_device)).cpu()
    assert float((got - want).abs().max()) <= 1e-5
    assert torch.equal(got[3], torch.zeros(MINILM_L6.d_model))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["", "int8"])
def test_dryrun_cache_pair_on_cuda(cuda_device, tmp_path, variant):
    """The dry run's sharded lookup+insert step on the card, four shards,
    at a reduced capacity: one cosine launch a shard and step."""
    from repro_torch.launch import dryrun
    kmod.reset_launches()
    art = dryrun.run_cache(str(tmp_path), variant, "cuda", capacity=65536,
                           batch=128, steps=2, verbose=False)
    assert art["ok"], art.get("traceback")
    assert art["entries"] == 128 and art["hits_last_step"] == 128
    assert kmod.launches["cosine_topk"] == 3 * dryrun.CACHE_SHARDS


@pytest.mark.cuda
def test_sharded_model_on_a_one_rank_nccl_mesh(cuda_device):
    """The multi-chip path on the card: reduced yi-6b in bf16 as a
    ``Model`` on a (1, 1) mesh of one NCCL rank (DTensor parameters, the
    attention kernels under ``local_map``) equals the unsharded model bit
    for bit over a prefill and three decode steps, the kernels launched.
    It checks the code path on DTensor inputs, not an exchange: NCCL
    refuses two ranks on one GPU."""
    import dataclasses
    import socket

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import make_local_mesh
    cfg = dataclasses.replace(get_arch("yi-6b").reduced(), dtype="bfloat16")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_local_mesh(1, 1, device_type="cuda")
        plain = Model(cfg, device=cuda_device).init_params(prng.key(0))
        sharded = Model(cfg, device=cuda_device, mesh=mesh)
        sharded.load_state_dict(plain.state_dict())
        assert isinstance(sharded.blocks["wq"], DTensor)
        tokens = torch.randint(0, cfg.vocab, (4, 32), device=cuda_device,
                               generator=torch.Generator(
                                   device=cuda_device).manual_seed(1))
        outs = {}
        for name, model in (("mesh", sharded), ("plain", plain)):
            kflash.reset_launches()
            kdec.reset_launches()
            with torch.no_grad():
                logits, caches = model.forward(tokens, collect_cache=True,
                                               cache_size=40)
                steps = [logits]
                for _ in range(3):
                    logits, caches = model.decode_step(
                        caches, steps[-1][:, -1:].argmax(-1).to(torch.int32))
                    steps.append(logits)
            outs[name] = [s.full_tensor() if isinstance(s, DTensor) else s
                          for s in steps]
            assert kflash.launches["flash_attention"] == cfg.n_layers
            assert kdec.launches["decode_attention"] == 3 * cfg.n_layers
        for got, want in zip(outs["mesh"], outs["plain"]):
            assert torch.equal(got, want)
    finally:
        dist.destroy_process_group()


def _example(name: str):
    path = Path(__file__).resolve().parents[1] / "examples_torch" / \
        f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close_leaves(got, want, tol, where=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _close_leaves(got[k], want[k], tol, f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _close_leaves(g, w, tol, f"{where}[{i}]")
    else:
        assert got == want or abs(got - want) <= tol, (where, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kernels", [
    ("quickstart", ("cosine_topk",)),
    ("serve_cached_chatbot", ("cosine_topk", "flash_attention",
                              "decode_attention", "threefry_normal")),
    ("train_small", ("threefry_normal",))])
def test_cuda_example_matches_cpu(cuda_device, name, kernels, capsys,
                                  tmp_path):
    """The example on the card launches its kernels and gives the CPU run's
    decisions and answers, scores within 1e-5 and counters within 1e-4
    (``train_small``, reduced for 12 steps: its loss curve, each device
    drawing its weights from key 0)."""
    mod = _example(name)
    argv = []
    if name == "train_small":
        argv = ["--reduced", "--steps", "12", "--checkpoint",
                str(tmp_path / "mamba2.npz")]
    for m in (kmod, kflash, kdec, kthreefry):
        m.reset_launches()
    card = mod.main(["--device", "cuda", *argv])
    launched = {**kmod.launches, **kflash.launches, **kdec.launches,
                **kthreefry.launches}
    assert all(launched[k] > 0 for k in kernels), launched
    cpu = mod.main(["--device", "cpu", *argv])
    capsys.readouterr()
    assert card["decisions"] == cpu["decisions"]
    _close_leaves(card["scores"], cpu["scores"], 1e-5, "scores")
    _close_leaves(card["counters"], cpu["counters"], 1e-4, "counters")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 2 ** 32 - 1000, 3 * 2 ** 32 + 7])
def test_cuda_threefry_matches_plain_version(cuda_device, dtype, offset):
    """The draw kernel against its plain version on the card: bits and
    uniforms bit for bit, normals (times a scale, in the leaf's dtype)
    within 1e-5 relative in f32 and at most a bf16 ulp apart in bf16; a
    draw at an offset is that slice of the whole draw; one launch a
    call."""
    key = tuple(int(k) for k in prng.key(11))
    n = 70001
    for kind, out_dtype in (("bits", torch.int64), ("uniform", torch.float32)):
        got = kthreefry.threefry_cuda(
            torch.empty(n, dtype=out_dtype, device=cuda_device), key,
            kind=kind, offset=offset, lo=0.0)
        want = tref.threefry_fill_ref(torch.empty_like(got), key, kind=kind,
                                      offset=offset, lo=0.0)
        assert torch.equal(got, want), kind
    kthreefry.reset_launches()
    got = prng.normal(prng.key(11), (7, n), scale=0.05,
                      dtype=getattr(torch, dtype), offset=offset,
                      device=cuda_device)
    assert kthreefry.launches["threefry_normal"] == 1
    want = prng.normal(prng.key(11), (7, n), scale=0.05,
                       dtype=getattr(torch, dtype), offset=offset,
                       device="cpu")
    a, b = got.cpu().float(), want.float()
    if dtype == "float32":
        assert float(((a - b).abs() / b.abs()).max()) <= 1e-5
    else:
        ulp = torch.finfo(torch.bfloat16).eps * torch.maximum(a.abs(),
                                                              b.abs())
        assert bool(torch.all((a - b).abs() <= ulp))
    part = prng.normal(prng.key(11), (n,), scale=0.05,
                       dtype=getattr(torch, dtype), offset=offset + 3 * n,
                       device=cuda_device)
    assert torch.equal(part, got[3])


def _original_windows(total: int, width: int) -> list[int]:
    """Offsets of windows of ``width`` around the original layout's seams
    in a draw of ``total`` (``ref.threefry_seams``)."""
    return sorted({min(max(p - width // 2, 0), total - width)
                   for p in tref.threefry_seams(total)})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("total", [70001, 2 ** 32 + 5, 2 * 128 * 5120 * 8192])
def test_cuda_threefry_original_layout_matches_plain_version(
        cuda_device, dtype, total):
    """The original layout (``jax_threefry_partitionable`` off) on the
    card against its plain version: bits and uniforms bit for bit, whole
    at an odd n (70,001) and over windows around h and each block end of
    larger draws (llama4's 2-layer expert leaf has two); normals through
    ``prng`` within 1e-5 relative in f32 and a bf16 ulp in bf16, across
    the first h; a window is that slice of the longer draw; one launch a
    call whatever its blocks."""
    key = tuple(int(k) for k in prng.key(11))
    width = min(total, 4099)
    for off in _original_windows(total, width):
        for kind, out_dtype in (("bits", torch.int64),
                                ("uniform", torch.float32)):
            kw = dict(kind=kind, offset=off, lo=0.0, layout="original",
                      total=total)
            kthreefry.reset_launches()
            got = kthreefry.threefry_cuda(
                torch.empty(width, dtype=out_dtype, device=cuda_device), key,
                **kw)
            assert kthreefry.launches["threefry_normal"] == 1
            want = tref.threefry_fill_ref(torch.empty_like(got), key, **kw)
            assert torch.equal(got, want), (kind, off)
    n, first = 1001, -(-min(total, tref.THREEFRY_BLOCK) // 2) - 3500
    with prng.partitionable(False):
        got = prng.normal(prng.key(11), (7, n), scale=0.05,
                          dtype=getattr(torch, dtype), offset=first,
                          total=total, device=cuda_device)
        want = prng.normal(prng.key(11), (7, n), scale=0.05,
                           dtype=getattr(torch, dtype), offset=first,
                           total=total, device="cpu")
        part = prng.normal(prng.key(11), (n,), scale=0.05,
                           dtype=getattr(torch, dtype),
                           offset=first + 3 * n, total=total,
                           device=cuda_device)
    a, b = got.cpu().float(), want.float()
    if dtype == "float32":
        assert float(((a - b).abs() / b.abs()).max()) <= 1e-5
    else:
        ulp = torch.finfo(torch.bfloat16).eps * torch.maximum(a.abs(),
                                                              b.abs())
        assert bool(torch.all((a - b).abs() <= ulp))
    assert torch.equal(part, got[3])


@pytest.mark.cuda
def test_cuda_init_params_draws_the_cpu_weights(cuda_device):
    """The reduced yi-6b drawn on the card from key 0 holds the CPU draw's
    weights within 1e-5 relative, one threefry launch a drawn leaf."""
    kthreefry.reset_launches()
    card = Model(get_arch("yi-6b").reduced(),
                 device=cuda_device).init_params(prng.key(0))
    assert kthreefry.launches["threefry_normal"] == 9
    cpu = Model(get_arch("yi-6b").reduced(), device="cpu").init_params(
        prng.key(0))
    for name, t in cpu.state_dict().items():
        got = card.state_dict()[name].cpu()
        assert float(((got - t).abs() / t.abs().clamp_min(1e-30)).max()) \
            <= 1e-5, name


@pytest.mark.cuda
def test_cuda_init_params_in_original_mode_draws_the_cpu_weights(
        cuda_device):
    """As above with threefry's original mode (jax < 0.5's default): the
    reduced hymba (whole leaves and the SSM layers' own keys) drawn on the
    card equals the CPU draw within 1e-5 relative, one launch a drawn
    leaf or SSM matrix."""
    cfg = get_arch("hymba-1.5b").reduced()
    with prng.partitionable(False):
        kthreefry.reset_launches()
        card = Model(cfg, device=cuda_device).init_params(prng.key(0))
        launches = kthreefry.launches["threefry_normal"]
        cpu = Model(cfg, device="cpu").init_params(prng.key(0))
    want = 0
    for name, t in cpu.named_parameters():
        if bool(torch.all((t == 0) | (t == 1))):
            continue
        want += math.prod(t.shape[:-2]) if ".ssm." in name else 1
    assert launches == want
    for name, t in cpu.state_dict().items():
        got = card.state_dict()[name].cpu()
        assert float(((got - t).abs() / t.abs().clamp_min(1e-30)).max()) \
            <= 1e-5, name
