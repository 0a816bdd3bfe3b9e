"""The port's cosine top-k against the JAX package's: the plain PyTorch
version against ``repro.kernels.ref`` and against the Pallas kernel in
interpret mode, on the same numpy-seeded inputs; the CUDA wrapper's argument
checks; the device dispatch. The CUDA kernel itself runs only on the card
(``test_torch_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.cosine_topk import cosine_topk_pallas
from repro_torch.core.index import ExactIndex
from repro_torch.core.similarity import masked_topk
from repro_torch.kernels import cosine_topk as kmod
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from test_torch_cuda import CASES, keys_to_torch, make_inputs

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
        valid = torch.ones((2, 16), dtype=torch.bool)
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
    before = kmod.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        kmod.cosine_topk_cuda(q, keys, valid, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        ExactIndex(backend="kernel").search(None, q, keys, valid)
    assert kmod.launches == before


def test_ops_sends_cpu_tensors_to_the_plain_version():
    q, keys, valid, _ = make_inputs(4, 200, 32, "f32", "random", 4, seed=3)
    args = (torch.from_numpy(q), torch.from_numpy(keys),
            torch.from_numpy(valid))
    before = kmod.launches
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
