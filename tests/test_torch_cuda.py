"""The port on the card: the CUDA cosine top-k kernels (shared mask, per-row
interval, dense per-row mask) against their plain PyTorch versions, and the
serve loop, single- and multi-tenant, on CUDA against the same loop on the
CPU. Every test here needs a CUDA device and skips without one. The file imports
neither jax nor the JAX package, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

It also holds the seeded kernel inputs that ``test_torch_kernels.py`` feeds
to the JAX package on the CPU."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cosine_topk as kmod
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve

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
@pytest.mark.parametrize("key_dtype", ["f32", "int8"])
@pytest.mark.parametrize("fused", [True, False])
def test_serve_loop_on_cuda_matches_cpu(cuda_device, key_dtype, fused):
    kw = dict(corpus=30, queries=15, batch=16, fused=fused,
              key_dtype=key_dtype, log=lambda *a: None)
    kmod.reset_launches()
    eng, requests, on_card = serve.run(device=str(cuda_device), **kw)
    # one search a batch
    assert kmod.launches == {"cosine_topk": -(-len(requests) // 16),
                             "cosine_topk_interval": 0,
                             "cosine_topk_masked": 0}
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
    assert kmod.launches == {"cosine_topk": 0,
                             "cosine_topk_interval": -(-len(requests) // 16),
                             "cosine_topk_masked": 0}
    cpu, _, on_cpu = serve.run(device="cpu", **kw)
    assert [(r.answer, r.cached) for r in on_card] == \
        [(r.answer, r.cached) for r in on_cpu]
    np.testing.assert_allclose([r.score for r in on_card],
                               [r.score for r in on_cpu], rtol=0, atol=1e-5)
    assert eng.tenant_stats() == cpu.tenant_stats()
    assert any(r.cached for r in on_card)
