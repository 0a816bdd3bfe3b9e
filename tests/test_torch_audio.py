"""The audio family on the CPU: MusicGen's delay pattern and the reduced
musicgen-large ``Model`` (summed codebook embeddings, one head per
codebook, the conditioning prefix through ``prefix_proj``, the prefill
caches, decode steps on (B, 1, C) tokens) against the JAX package, on
inputs made with numpy from a seed and weights carried across with
``convert.params_from_jax``; and the text miss path's refusal of an audio
model, beside the JAX backend's failure.

Tolerances as ``test_torch_models.py`` states them: ``F32_TOL`` on f32
logits and KV caches, ``BF16_MODEL_REL`` of the largest logit in bf16;
greedy tokens (every codebook's) equal but at near-ties.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.data import audio_delay as jdelay
from repro.data.tokenizer import HashTokenizer as JTokenizer
from repro.models.model import Model as JModel
from repro.serving import ModelBackend as JModelBackend
from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.data import audio_delay as tdelay
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serving import ModelBackend
from test_torch_models import (BF16_MODEL_REL, F32_TOL, SMALL_BF16,
                               _same_greedy, f32, models)

ARCH = "musicgen-large"


@pytest.mark.parametrize("b,t,k,pad", [(2, 7, 4, 0), (1, 1, 4, 5),
                                       (3, 12, 2, 2047), (2, 5, 1, 0)])
def test_delay_pattern_matches_jax(b, t, k, pad):
    """``apply_delay`` / ``remove_delay`` equal the JAX package's numpy
    functions, and removing the delay gives the frames back."""
    frames = np.random.default_rng(t * k).integers(
        0, 2048, (b, t, k)).astype(np.int32)
    delayed = tdelay.apply_delay(frames, pad_id=pad)
    assert delayed.shape == (b, t + k - 1, k) and delayed.dtype == np.int32
    assert np.array_equal(delayed, jdelay.apply_delay(frames, pad_id=pad))
    back = tdelay.remove_delay(delayed, t, pad_id=pad)
    assert np.array_equal(back, jdelay.remove_delay(delayed, t, pad_id=pad))
    assert np.array_equal(back, frames)


def _audio_batch(cfg, b, frames, seed):
    """Delayed codebook tokens (B, T + C - 1, C) and conditioning frames
    (B, n_prefix, d), as musicgen's data pipeline would give them."""
    rng = np.random.default_rng(seed)
    grid = rng.integers(1, cfg.vocab, (b, frames, cfg.n_codebooks)).astype(
        np.int32)
    pre = rng.standard_normal((b, cfg.n_prefix, cfg.d_model)).astype(
        np.float32)
    return tdelay.apply_delay(grid), pre


def audio_matches_jax(jcfg, tcfg, steps=6):
    """Logits (B, L, C, Vp) and prefill caches of ``forward`` behind the
    conditioning prefix, then ``steps`` ``decode_step``s on (B, 1, C)
    tokens fed JAX's greedy tokens, against the JAX ``Model``."""
    jm, params, tm = models(jcfg, tcfg)
    toks, pre = _audio_batch(jcfg, 2, 9, seed=3)
    cache = toks.shape[1] + jcfg.n_prefix + steps + 2
    jl, jc, _ = jm.forward(params, jnp.asarray(toks),
                           prefix_emb=jnp.asarray(pre), collect_cache=True,
                           cache_size=cache)
    with torch.inference_mode():
        tl, tc = tm(torch.from_numpy(toks).long(),
                    prefix_emb=torch.from_numpy(pre), collect_cache=True,
                    cache_size=cache)
    jl = f32(jl)
    assert tl.shape == jl.shape == (2, toks.shape[1], jcfg.n_codebooks,
                                    jcfg.padded_vocab)
    bf16 = jcfg.dtype == "bfloat16"
    tol = BF16_MODEL_REL * np.abs(jl).max() if bf16 else F32_TOL
    np.testing.assert_allclose(f32(tl), jl, rtol=0, atol=tol)
    assert np.all(f32(tl)[..., jcfg.vocab:] == -1e9)
    cache_tol = dict(rtol=0, atol=0.05 if bf16 else F32_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(f32(getattr(tc.kv, name)),
                                   f32(getattr(jc.kv, name)), **cache_tol)
    assert tc.kv.pos == int(jc.kv.pos) == toks.shape[1] + jcfg.n_prefix
    tie = 2 * np.abs(f32(tl) - jl).max() if bf16 else 1e-4
    _same_greedy(jl, f32(tl), "musicgen forward", tie)
    nt = jl[:, -1:].argmax(-1)                       # (B, 1, C)
    decode = jax.jit(jm.decode_step)
    for step in range(steps):
        jd, jc = decode(params, jc, jnp.asarray(nt))
        with torch.inference_mode():
            td, tc = tm.decode_step(tc, torch.from_numpy(nt).long())
        jd = f32(jd)
        assert td.shape == (2, 1, jcfg.n_codebooks, jcfg.padded_vocab)
        tol = BF16_MODEL_REL * np.abs(jd).max() if bf16 else F32_TOL
        np.testing.assert_allclose(f32(td), jd, rtol=0, atol=tol)
        tie = 2 * np.abs(f32(td) - jd).max() if bf16 else 1e-4
        _same_greedy(jd, f32(td), f"musicgen decode step {step}", tie)
        nt = jd.argmax(-1)


def test_audio_model_matches_jax():
    audio_matches_jax(jget_arch(ARCH).reduced(), get_arch(ARCH).reduced())


def test_audio_model_bf16_at_its_head_geometry_matches_jax():
    """musicgen's attention geometry (H = HKV = 32, D = 64, G = 1) and its
    four codebooks in bf16 at a small width."""
    small = dict(SMALL_BF16, n_prefix=8)
    audio_matches_jax(dataclasses.replace(jget_arch(ARCH), **small),
                      dataclasses.replace(get_arch(ARCH), **small), steps=3)


def test_audio_decode_continues_its_forward():
    """Prefill then one decode step equals the forward of the extended
    delayed sequence at that position, with the prefix."""
    cfg = get_arch(ARCH).reduced()
    tm = Model(cfg, device="cpu").init_params(prng.key(0))
    toks, pre = map(torch.from_numpy, _audio_batch(cfg, 2, 10, seed=4))
    toks = toks.long()
    with torch.inference_mode():
        lg, caches = tm(toks, prefix_emb=pre, collect_cache=True,
                        cache_size=64)
        nt = lg[:, -1:].argmax(-1)
        dl, _ = tm.decode_step(caches, nt)
        lg2 = tm(torch.cat([toks, nt], dim=1), prefix_emb=pre)
    assert float((dl[:, 0] - lg2[:, -1]).abs().max()) < F32_TOL


def test_params_from_jax_carries_the_codebook_leaves():
    """``convert`` carries the (C, Vp, d) embeddings, (C, d, Vp) heads and
    ``prefix_proj`` of the audio family bit for bit, bf16 included."""
    jcfg = dataclasses.replace(jget_arch(ARCH), **SMALL_BF16, n_prefix=8)
    tcfg = dataclasses.replace(get_arch(ARCH), **SMALL_BF16, n_prefix=8)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        JModel(jcfg).init_params)(jax.random.PRNGKey(1)))
    tm = Model(tcfg, device="cpu")
    state = params_from_jax(params)
    assert set(state) == set(tm.state_dict())
    tm.load_state_dict(state)
    c, vp, d = tcfg.n_codebooks, tcfg.padded_vocab, tcfg.d_model
    assert tuple(tm.embed.shape) == params["embed"].shape == (c, vp, d)
    assert tuple(tm.lm_head.shape) == params["lm_head"].shape == (c, d, vp)
    assert tuple(tm.prefix_proj.shape) == (d, d)
    for name in ("embed", "lm_head", "prefix_proj"):
        t = getattr(tm, name)
        assert t.dtype == torch.bfloat16
        assert np.array_equal(f32(t), params[name].astype(np.float32))


def test_text_miss_path_refuses_audio_as_the_reference_fails():
    """The reference's ``ModelBackend`` tokenizes text into (B, L) ids
    that ``_embed`` reads as codebooks, and fails inside the forward; the
    port's backend (and ``serve --arch musicgen-large``) refuses an audio
    model up front with a ValueError naming the one-codebook text path.
    The audio model itself still refuses (B, L) tokens clearly."""
    jcfg = jget_arch(ARCH).reduced()
    jm = JModel(jcfg)
    jparams = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    backend = JModelBackend(jm, jparams, JTokenizer(vocab_size=jcfg.vocab),
                            max_prompt_len=8, max_new_tokens=2)
    with pytest.raises(ValueError):
        backend.generate(["how do I reset my router"])
    tm = Model(get_arch(ARCH).reduced(), device="cpu")
    with pytest.raises(ValueError, match="one codebook"):
        ModelBackend(tm, HashTokenizer(vocab_size=jcfg.vocab))
    with pytest.raises(ValueError, match="one codebook"):
        serve.build(corpus=2, queries=1, backend="model", arch=ARCH,
                    device="cpu", log=lambda *a: None)
    with pytest.raises(ValueError, match="codebook tokens"):
        tm(torch.zeros((1, 4), dtype=torch.long))
