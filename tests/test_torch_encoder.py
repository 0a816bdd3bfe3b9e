"""The MiniLM encoder (``repro_torch.embedding.encoder``) against the JAX
package's ``repro.embedding.encoder`` on the CPU, on the JAX parameters
carried across (``convert.tree_from_jax``) and tokens made with numpy from
a seed; and the reference's own contract checks on the port.

Tolerance: 1e-5 absolute on the unit embeddings, f32 both sides. The two
packages sum the same f32 products in other orders; measured differences
are ~1e-7. The card twin lives in ``test_torch_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.embedding import encoder as jenc
from repro_torch import prng
from repro_torch.embedding import (MINILM_L6, EncoderConfig, encode,
                                   init_encoder_params)
from repro_torch.models.convert import tree_from_jax

TOL = 1e-5
NARROW = EncoderConfig(vocab=512, d_model=64, n_layers=2, n_heads=4,
                       d_ff=128, max_len=32)


def _jax_params(cfg, seed=0):
    params = jax.jit(lambda k: jenc.init_encoder_params(k, cfg))(
        jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, params)


def _inputs(cfg, b, l, lengths, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(b, l), dtype=np.int32)
    return tokens, np.asarray(lengths, dtype=np.int32)


def test_config_matches_reference():
    assert dataclasses.asdict(MINILM_L6) == dataclasses.asdict(jenc.MINILM_L6)
    assert MINILM_L6.head_dim == jenc.MINILM_L6.head_dim == 32


@pytest.mark.parametrize("cfg,lengths", [
    (NARROW, [16, 7, 1, 0]),
    (MINILM_L6, [16, 1, 0]),
], ids=["narrow", "minilm_l6"])
def test_encode_matches_jax(cfg, lengths):
    jparams = _jax_params(cfg)
    tokens, lens = _inputs(cfg, len(lengths), 16, lengths)
    want = np.asarray(jenc.encode(jax.tree_util.tree_map(jnp.asarray,
                                                         jparams),
                                  jnp.asarray(tokens), jnp.asarray(lens),
                                  cfg))
    got = encode(tree_from_jax(jparams, device="cpu"),
                 torch.from_numpy(tokens), torch.from_numpy(lens), cfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.isfinite(want).all() and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # a row of length 0 pools to zero and stays zero through the floor
    np.testing.assert_array_equal(got[lens == 0].numpy(), 0.0)


def test_params_tree_and_scales():
    params = init_encoder_params(prng.key(0), NARROW, device="cpu")
    want = jax.tree_util.tree_map(
        lambda a: (a.shape, a.dtype.name), _jax_params(NARROW))
    got = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")),
        params)
    assert got == want
    d, ff = NARROW.d_model, NARROW.d_ff
    for name, scale in (("wqkv", d ** -0.5), ("w2", ff ** -0.5)):
        std = float(params["blocks"][name].std())
        assert abs(std / scale - 1) < 0.05, (name, std, scale)
    assert float(params["embed"].std()) == pytest.approx(0.02, rel=0.05)
    assert torch.equal(params["final_norm"], torch.ones(d))


def test_output_contract():
    """The reference's ``TestEncoder.test_output_contract`` on the port."""
    gen = torch.Generator().manual_seed(0)
    params = init_encoder_params(prng.key(0), device="cpu")
    tokens = torch.randint(0, MINILM_L6.vocab, (3, 16), generator=gen)
    emb = encode(params, tokens, torch.tensor([16, 8, 1]))
    assert emb.shape == (3, MINILM_L6.d_model)
    np.testing.assert_allclose(torch.linalg.vector_norm(emb, dim=-1).numpy(),
                               1.0, rtol=1e-5)


def test_padding_invariance():
    """Positions at or past a row's length do not move it (the reference's
    ``test_padding_invariance``)."""
    gen = torch.Generator().manual_seed(0)
    params = init_encoder_params(prng.key(0), device="cpu")
    t1 = torch.randint(3, 1000, (1, 16), generator=gen)
    t2 = t1.clone()
    t2[:, 8:] = 999
    lens = torch.tensor([8])
    np.testing.assert_allclose(encode(params, t1, lens).numpy(),
                               encode(params, t2, lens).numpy(), atol=1e-5)


def test_too_long_raises():
    params = init_encoder_params(prng.key(0), NARROW, device="cpu")
    tokens = torch.zeros((1, NARROW.max_len + 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="max_len"):
        encode(params, tokens, torch.tensor([4]), NARROW)


def test_init_needs_a_device_it_has():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_encoder_params(prng.key(0), NARROW)
