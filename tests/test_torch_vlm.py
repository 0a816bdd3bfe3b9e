"""The vlm family on the CPU: M-RoPE (``apply_mrope``, ``positionize``, the
stub ViT's grid positions) and the reduced qwen2-vl-2b ``Model`` (the
patch prefix through ``prefix_proj`` at grid positions, text shifted past
it, prefill caches, decode positions through ``positionize``, int8 KV
decode, text-only serving behind the cache) against the JAX package, on
inputs made with numpy from a seed and weights carried across with
``convert.params_from_jax``.

Tolerances as ``test_torch_models.py`` states them: 1e-6 on M-RoPE
outputs of unit-scale inputs (the same f32 cos/sin products),
``F32_TOL`` on f32 logits and caches, ``BF16_MODEL_REL`` of the largest
logit in bf16, ``INT8_KV_TOL`` on logits decoded from int8 caches; greedy
tokens equal but at near-ties.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import layers as jlayers
from repro.models.model import Model as JModel
from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.models import layers as tlayers
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from test_torch_models import (BF16_MODEL_REL, F32_TOL, INT8_KV_TOL,
                               SMALL_BF16, _check_caches, _same_greedy,
                               _tokens, f32, model_matches_jax, models,
                               serve_matches_jax)

ARCH = "qwen2-vl-2b"
ROPE_TOL = 1e-6


@pytest.mark.parametrize("sections,theta", [((8, 12, 12), 1e6),
                                            ((16, 24, 24), 1e6),
                                            ((4, 2, 10), 1e4)])
def test_apply_mrope_matches_jax(sections, theta):
    """Random (t, h, w) triples, and text positions (t = h = w, where
    M-RoPE is standard RoPE)."""
    d = 2 * sum(sections)
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 7, 3, d)).astype(np.float32)
    pos3 = rng.integers(0, 500, (2, 7, 3)).astype(np.int32)
    got = tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                              theta, sections)
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), theta,
                               sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ROPE_TOL)
    text = np.repeat(np.arange(7, dtype=np.int32)[None, :, None] + 40, 3, -1)
    np.testing.assert_allclose(
        tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(text),
                            theta, sections).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(
            text[..., 0]), theta)), rtol=0, atol=ROPE_TOL)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    gb = tlayers.apply_mrope(xb, torch.from_numpy(pos3), theta, sections)
    wb = jlayers.apply_mrope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos3),
                             theta, sections)
    assert gb.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(gb), f32(wb), rtol=2.0 ** -7, atol=1e-6)


def test_positionize_and_rope_for_match_jax():
    jcfg, tcfg = jget_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    for shape in ((2, 5), (2, 1), (4,)):
        pos = np.random.default_rng(len(shape)).integers(
            0, 99, shape).astype(np.int32)
        got = tlayers.positionize(tcfg, torch.from_numpy(pos))
        want = jlayers.positionize(jcfg, jnp.asarray(pos))
        assert np.array_equal(got.numpy(), np.asarray(want))
    pos3 = np.random.default_rng(0).integers(0, 9, (2, 5, 3)).astype(np.int32)
    assert np.array_equal(tlayers.positionize(tcfg, torch.from_numpy(
        pos3)).numpy(), np.asarray(jlayers.positionize(jcfg, pos3)))
    x = np.random.default_rng(1).standard_normal((2, 5, 2, 64)).astype(
        np.float32)
    np.testing.assert_allclose(
        tlayers.rope_for(tcfg, torch.from_numpy(x), torch.from_numpy(
            pos3)).numpy(),
        np.asarray(jlayers.rope_for(jcfg, jnp.asarray(x), jnp.asarray(pos3))),
        rtol=0, atol=ROPE_TOL)
    dense = get_arch("yi-6b").reduced()
    pos = torch.arange(5, dtype=torch.int32)[None]
    assert tlayers.positionize(dense, pos) is pos


@pytest.mark.parametrize("b,n", [(2, 16), (1, 256), (3, 10), (1, 1)])
def test_grid_positions_match_jax(b, n):
    """The stub ViT's patch grid: t = 0, h = row, w = col on a square of
    side int(sqrt(n)) (a ragged last row where n is not a square)."""
    jm = JModel(jget_arch(ARCH).reduced())
    want = np.asarray(jm._mrope_grid_positions(b, n))
    got = Model._mrope_grid_positions(b, n, "cpu")
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def _prefix(cfg, b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.n_prefix, cfg.d_model)).astype(np.float32)


def vlm_matches_jax(jcfg, tcfg, steps=6, quantized=False):
    """Logits and prefill caches of ``forward`` behind the patch prefix,
    then ``steps`` decode steps fed JAX's greedy tokens (from the prefill's
    caches, or from empty int8 caches), against the JAX ``Model``."""
    jm, params, tm = models(jcfg, tcfg)
    toks = _tokens(jcfg.vocab, 3, 12, seed=6)
    pre = _prefix(jcfg, 3, seed=7)
    cache = toks.shape[1] + jcfg.n_prefix + steps + 2
    jl, jc, _ = jm.forward(params, jnp.asarray(toks),
                           prefix_emb=jnp.asarray(pre), collect_cache=True,
                           cache_size=cache)
    with torch.inference_mode():
        tl, tc = tm(torch.from_numpy(toks).long(),
                    prefix_emb=torch.from_numpy(pre), collect_cache=True,
                    cache_size=cache)
    jl = f32(jl)
    bf16 = jcfg.dtype == "bfloat16"
    tol = BF16_MODEL_REL * np.abs(jl).max() if bf16 else F32_TOL
    np.testing.assert_allclose(f32(tl), jl, rtol=0, atol=tol)
    cache_tol = dict(rtol=0, atol=0.05 if bf16 else F32_TOL)
    _check_caches(jc, tc, cache_tol)
    tie = 2 * np.abs(f32(tl) - jl).max() if bf16 else 1e-4
    _same_greedy(jl, f32(tl), "qwen2-vl forward", tie)
    nt = jl[:, -1:].argmax(-1)
    if quantized:
        jc = jm.init_decode_caches(3, 16, kv_quantized=True)
        tc = tm.init_decode_caches(3, 16, kv_quantized=True)
    decode = jax.jit(jm.decode_step)
    for step in range(steps):
        jd, jc = decode(params, jc, jnp.asarray(nt))
        with torch.inference_mode():
            td, tc = tm.decode_step(tc, torch.from_numpy(nt).long())
        jd = f32(jd)
        tol = INT8_KV_TOL if quantized else (
            BF16_MODEL_REL * np.abs(jd).max() if bf16 else F32_TOL)
        np.testing.assert_allclose(f32(td), jd, rtol=0, atol=tol)
        assert tc.kv.pos == int(jc.kv.pos)
        assert np.array_equal(tc.kv.slot_pos.numpy(),
                              np.asarray(jc.kv.slot_pos))
        tie = 2 * np.abs(f32(td) - jd).max() if bf16 or quantized else 1e-4
        _same_greedy(jd, f32(td), f"qwen2-vl decode step {step}", tie)
        nt = jd.argmax(-1)


def test_vlm_model_with_patch_prefix_matches_jax():
    vlm_matches_jax(jget_arch(ARCH).reduced(), get_arch(ARCH).reduced())


def test_vlm_model_bf16_at_its_head_geometry_matches_jax():
    """qwen2-vl's attention geometry (H=12, HKV=2, D=128, M-RoPE sections
    16/24/24, theta 1e6) in bf16 at a small width, behind a 16-patch
    prefix."""
    small = dict(SMALL_BF16, n_prefix=16)
    vlm_matches_jax(dataclasses.replace(jget_arch(ARCH), **small),
                    dataclasses.replace(get_arch(ARCH), **small), steps=3)


def test_vlm_text_only_matches_jax():
    """Without a prefix (the text miss path): positions t = h = w."""
    model_matches_jax(ARCH, False, steps=4)


def test_vlm_int8_kv_decode_matches_jax_logits():
    """Decoding from int8 KV caches against the JAX model's int8 decode
    logits directly (the JAX package's own int8-vs-bf16 test of this
    config fails on its tolerance; this holds the two int8 paths to each
    other)."""
    vlm_matches_jax(jget_arch(ARCH).reduced(), get_arch(ARCH).reduced(),
                    steps=20, quantized=True)


def test_vlm_decode_continues_its_forward_behind_the_prefix():
    cfg = get_arch(ARCH).reduced()
    tm = Model(cfg, device="cpu").init_params(prng.key(0))
    toks = torch.from_numpy(_tokens(cfg.vocab, 2, 20, seed=8)).long()
    pre = torch.from_numpy(_prefix(cfg, 2, seed=9))
    with torch.inference_mode():
        lg, caches = tm(toks, prefix_emb=pre, collect_cache=True,
                        cache_size=64)
        nt = lg[:, -1:].argmax(-1)
        dl, _ = tm.decode_step(caches, nt)
        lg2 = tm(torch.cat([toks, nt], dim=1), prefix_emb=pre)
    assert float((dl[:, 0] - lg2[:, -1]).abs().max()) < F32_TOL


def test_params_from_jax_carries_prefix_proj():
    jcfg = dataclasses.replace(jget_arch(ARCH), **SMALL_BF16, n_prefix=4)
    tcfg = dataclasses.replace(get_arch(ARCH), **SMALL_BF16, n_prefix=4)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        JModel(jcfg).init_params)(jax.random.PRNGKey(2)))
    tm = Model(tcfg, device="cpu")
    state = params_from_jax(params)
    assert set(state) == set(tm.state_dict()) and "prefix_proj" in state
    tm.load_state_dict(state)
    for name, t in tm.state_dict().items():
        top, _, sub = name.partition(".")
        leaf = params[top][sub] if sub else params[top]
        assert tuple(t.shape) == leaf.shape
        assert np.array_equal(f32(t), leaf.astype(np.float32))
    with pytest.raises(ValueError, match="n_prefix"):
        Model(get_arch("yi-6b").reduced(), device="cpu")(
            torch.zeros((1, 3), dtype=torch.long),
            prefix_emb=torch.zeros((1, 2, 256)))


def test_serve_vlm_text_only_matches_jax_serve():
    """``launch.serve --backend model --arch qwen2-vl-2b --device cpu``
    gives ``repro.launch.serve``'s hits and answers request by request."""
    serve_matches_jax(ARCH)
