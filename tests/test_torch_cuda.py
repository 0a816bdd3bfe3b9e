"""The port on the card: the CUDA cosine top-k against its plain PyTorch
version, and the serve loop on CUDA against the same loop on the CPU. Every
test here needs a CUDA device and skips without one. The file imports
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
    before = kmod.launches
    ks, ki = kmod.cosine_topk_cuda(*args, k)
    assert kmod.launches == before + 1
    rs, ri = tref.cosine_topk_ref(*[a.cpu() for a in args], k)
    torch.testing.assert_close(ks.cpu(), rs, rtol=0, atol=1e-5)
    assert torch.equal(ki.cpu(), ri)


@pytest.mark.cuda
@pytest.mark.parametrize("key_dtype", ["f32", "int8"])
@pytest.mark.parametrize("fused", [True, False])
def test_serve_loop_on_cuda_matches_cpu(cuda_device, key_dtype, fused):
    kw = dict(corpus=30, queries=15, batch=16, fused=fused,
              key_dtype=key_dtype, log=lambda *a: None)
    kmod.launches = 0
    eng, requests, on_card = serve.run(device=str(cuda_device), **kw)
    assert kmod.launches == -(-len(requests) // 16)   # one search a batch
    _, _, on_cpu = serve.run(device="cpu", **kw)
    assert [(r.answer, r.cached) for r in on_card] == \
        [(r.answer, r.cached) for r in on_cpu]
    np.testing.assert_allclose([r.score for r in on_card],
                               [r.score for r in on_cpu], rtol=0, atol=1e-5)
    assert any(r.cached for r in on_card)
