"""The model-backed miss path on the CPU: the port's layers, attention
plain versions, ``Model`` (forward, prefill caches, decode steps),
``ModelBackend`` and ``launch.serve --backend model`` against the JAX
package, on inputs made with numpy from a seed and weights carried across
with ``convert.params_from_jax``.

Tolerances, with their reasons:
  * f32: 1e-4 on logits and attention outputs. The two packages sum the
    same f32 products in different orders (measured: ~5e-6 on logits of
    magnitude ~4).
  * bf16 layers: 1 bf16 ulp of the output (rtol 2**-7), where the only
    difference is the rounding of an f32 intermediate.
  * bf16 model: 2% of the largest logit (about 2.5 bf16 ulps of it). A
    bf16 matmul output that lands on a rounding boundary rounds one way in
    XLA and the other in PyTorch (measured: 4e-5 of a projection's
    outputs), and the flips carry through two layers.
  * int8 KV caches: 5e-3 on logits. The f32 K/V of the two packages
    differ by ~1e-6, so now and then a value crosses an int8 rounding
    boundary and moves by one quantum (absmax / 127): 2 of 4,096 V entries
    after 20 steps here, 1e-3 on the logits.
  * Greedy tokens: equal, except where the JAX logits' top-two gap at that
    step is under ``TIE_TOL`` (f32) or, in bf16, under twice the largest
    logit difference of that step (a token can flip only where the gap is
    below the sum of the two logits' differences); such a near-tie is
    reported and only the logits are compared there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core.types import CacheConfig as JConfig
from repro.data.qa_dataset import build_corpus, build_test_queries
from repro.data.tokenizer import HashTokenizer as JTokenizer
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.model import Model as JModel
from repro.serving import CachedEngine as JEngine
from repro.serving import ModelBackend as JModelBackend
from repro.serving import Request as JRequest
from repro_torch.configs import ARCHITECTURES, get_arch
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.convert import params_from_jax, to_tensor
from repro_torch.models.model import Model
from repro_torch.serving import ModelBackend

F32_TOL = 1e-4
INT8_KV_TOL = 5e-3
BF16_ULP = 2.0 ** -7
BF16_MODEL_REL = 0.02
TIE_TOL = 1e-4
DENSE = ["yi-6b", "deepseek-7b", "minitron-8b"]
# yi-6b's attention geometry (H=32, HKV=4, D=128) and dtype at a small width
SMALL_BF16 = dict(n_layers=2, d_model=256, d_ff=512, vocab=1024,
                  vocab_pad_multiple=128)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def jnp_of(x: np.ndarray, dtype: str):
    return jnp.asarray(x, getattr(jnp, dtype))


def torch_of(x: np.ndarray, dtype: str):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def configs(arch: str, bf16_small: bool = False):
    """(JAX config, port config): reduced, or the arch's published
    attention, expert and SSM geometry in bf16 at ``SMALL_BF16``'s width
    (an MLP only where the arch has one)."""
    if bf16_small:
        small = dict(SMALL_BF16, d_ff=SMALL_BF16["d_ff"]
                     if get_arch(arch).d_ff else 0)
        return (dataclasses.replace(jget_arch(arch), **small),
                dataclasses.replace(get_arch(arch), **small))
    return jget_arch(arch).reduced(), get_arch(arch).reduced()


def models(jcfg, tcfg, seed=0):
    """The JAX model with its random init (jitted: one compile, where the
    eager init of the moe and hybrid trees takes seconds), and the port's
    with the same weights."""
    jm = JModel(jcfg)
    params = jax.jit(jm.init_params)(jax.random.PRNGKey(seed))
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


# --------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 5)).astype(np.int32)
    tol = dict(rtol=BF16_ULP, atol=1e-6) if dtype == "bfloat16" else \
        dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        f32(tlayers.rms_norm(torch_of(x, dtype), torch.from_numpy(w))),
        f32(jlayers.rms_norm(jnp_of(x, dtype), jnp.asarray(w))), **tol)
    np.testing.assert_allclose(
        tlayers.rope_freqs(64, 10000.0).numpy(),
        np.asarray(jlayers.rope_freqs(64, 10000.0)), rtol=1e-6)
    np.testing.assert_allclose(
        f32(tlayers.apply_rope(torch_of(x, dtype), torch.from_numpy(pos),
                               10000.0)),
        f32(jlayers.apply_rope(jnp_of(x, dtype), jnp.asarray(pos), 10000.0)),
        **tol)
    # rope promotes bf16 to f32 against f32 cos/sin and casts back once
    assert tlayers.apply_rope(torch_of(x, dtype), torch.from_numpy(pos),
                              1e4).dtype == getattr(torch, dtype)
    d, ff = 32, 48
    h = rng.standard_normal((4, d)).astype(np.float32)
    wg, wu = (rng.standard_normal((d, ff)).astype(np.float32) * 0.2
              for _ in range(2))
    wd = rng.standard_normal((ff, d)).astype(np.float32) * 0.2
    mlp_tol = dict(rtol=4 * BF16_ULP, atol=1e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        f32(tlayers.swiglu(*(torch_of(a, dtype) for a in (h, wg, wu, wd)))),
        f32(jlayers.swiglu(*(jnp_of(a, dtype) for a in (h, wg, wu, wd)))),
        **mlp_tol)
    table = rng.standard_normal((50, d)).astype(np.float32)
    toks = rng.integers(0, 50, (3, 7))
    assert np.array_equal(
        f32(tlayers.embed_tokens(torch_of(table, dtype), torch.from_numpy(
            toks))), f32(jlayers.embed_tokens(jnp_of(table, dtype), toks)))
    head = rng.standard_normal((d, 40)).astype(np.float32)
    tu = tlayers.unembed(torch_of(h, dtype), torch_of(head, dtype), 33)
    ju = jlayers.unembed(jnp_of(h, dtype), jnp_of(head, dtype), 33)
    np.testing.assert_allclose(f32(tu), f32(ju), **mlp_tol)
    assert np.all(f32(tu)[:, 33:] == f32(ju)[:, 33:])   # -1e9, not -inf
    assert np.all(f32(tu)[:, 33:] < -9e8)


def test_mrope_raises():
    cfg = get_arch("qwen2-vl-2b").reduced()
    x = torch.zeros((1, 2, 2, 64))
    with pytest.raises(NotImplementedError, match="vlm slice"):
        tlayers.rope_for(cfg, x, torch.zeros((1, 2), dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="vlm slice"):
        tlayers.positionize(cfg, torch.zeros((1, 2), dtype=torch.int32))


# --------------------------------------------------------------------- #
# attention plain versions
# --------------------------------------------------------------------- #
FLASH_CASES = [  # (B, Lq, Lk, H, HKV, D, causal, window)
    (2, 64, 64, 4, 4, 64, True, None),       # G=1
    (2, 64, 64, 4, 2, 64, True, None),       # G=2
    (1, 64, 64, 8, 1, 32, True, None),       # G=8 (MQA)
    (1, 64, 128, 4, 2, 64, True, None),      # Lk > Lq
    (2, 128, 128, 8, 1, 64, True, 48),       # window, G=8
    (1, 64, 128, 4, 2, 32, True, 40),        # window and Lk > Lq
    (1, 64, 64, 2, 2, 64, False, None),      # bidirectional
]


def _qkv(b, lq, lk, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, lq, h, d)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((b, lk, hkv, d)) * 0.3).astype(np.float32)
    v = rng.standard_normal((b, lk, hkv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("b,lq,lk,h,hkv,d,causal,window", FLASH_CASES)
def test_flash_attention_ref_matches_jax(b, lq, lk, h, hkv, d, causal,
                                         window):
    """Against JAX's model-path ``blockwise_attention``, its oracle (K/V
    expanded to H heads, the trap of the JAX ref's layout) and the Pallas
    kernel in interpret mode."""
    q, k, v = _qkv(b, lq, lk, h, hkv, d, seed=lq * lk + h)
    out = tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal, window=window).numpy()
    g = h // hkv
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    oracle = jref.flash_attention_ref(jq, jnp.repeat(jk, g, axis=2),
                                      jnp.repeat(jv, g, axis=2),
                                      causal=causal, window=window)
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                    block_q=64, block_k=64, interpret=True)
    for other in (oracle, pallas):
        np.testing.assert_allclose(out, np.asarray(other), rtol=F32_TOL,
                                   atol=F32_TOL)
    if causal:   # blockwise_attention is causal by construction here
        blockwise = jattn.blockwise_attention(jq, jk, jv, causal=True,
                                              window=window, block_q=32,
                                              block_k=32)
        np.testing.assert_allclose(out, np.asarray(blockwise),
                                   rtol=F32_TOL, atol=F32_TOL)


def test_flash_attention_ref_bf16_and_sinks():
    q, k, v = _qkv(1, 64, 64, 4, 2, 64, seed=5)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = tref.flash_attention_ref(tq, tk, tv, causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        f32(out), f32(jattn.blockwise_attention(jq, jk, jv, causal=True)),
        rtol=BF16_ULP, atol=1e-3)
    # attention sinks (hymba): the CPU path takes them
    out = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), window=16,
                              n_sink=8)
    want = jattn.blockwise_attention(*map(jnp.asarray, (q, k, v)),
                                     window=16, n_sink=8, block_q=16,
                                     block_k=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


DECODE_CASES = [  # the JAX suite's (tests/test_kernels.py), B, S, H, HKV, D
    (2, 128, 4, 2, 64, None, 0, "float32"),
    (1, 256, 8, 8, 64, 64, 0, "float32"),
    (2, 128, 4, 1, 128, None, 0, "int8"),
    (1, 256, 6, 2, 64, 32, 8, "int8"),
    (3, 64, 2, 2, 64, None, 0, "int8"),
    (2, 96, 32, 4, 128, None, 0, "bfloat16"),   # the serve path's heads
]


def _decode_inputs(b, s, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, 1, h, d)) * 0.3).astype(np.float32)
    kc = (rng.standard_normal((b, s, hkv, d)) * 0.3).astype(np.float32)
    vc = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    return q, kc, vc


@pytest.mark.parametrize("b,s,h,hkv,d,window,sink,kind", DECODE_CASES)
def test_decode_attention_ref_matches_jax(b, s, h, hkv, d, window, sink,
                                          kind):
    q, kc, vc = _decode_inputs(b, s, h, hkv, d, seed=b * s + h)
    slot_pos = np.arange(s, dtype=np.int32)
    pos = s - 1
    if kind == "int8":
        # jitted, as the JAX model's decode step runs it
        kq, ks = jax.jit(jattn.quantize_kv)(jnp.asarray(kc))
        vq, vs = jax.jit(jattn.quantize_kv)(jnp.asarray(vc))
        tkq, tks = tattn.quantize_kv(torch.from_numpy(kc))
        tvq, tvs = tattn.quantize_kv(torch.from_numpy(vc))
        assert np.array_equal(np.asarray(kq), tkq.numpy())
        np.testing.assert_array_equal(np.asarray(ks), tks.numpy())
        np.testing.assert_array_equal(
            tattn.dequantize_kv(tkq, tks).numpy(),
            np.asarray(jattn.dequantize_kv(kq, ks)))
        jargs = (jnp.asarray(q), kq, vq)
        targs = (torch.from_numpy(q), tkq, tvq)
        jkw = dict(k_scale=ks, v_scale=vs)
        tkw = dict(k_scale=tks, v_scale=tvs)
    else:
        jargs = (jnp_of(q, kind), jnp_of(kc, kind), jnp_of(vc, kind))
        targs = (torch_of(q, kind), torch_of(kc, kind), torch_of(vc, kind))
        jkw = tkw = {}
    out = tref.decode_attention_ref(*targs, torch.from_numpy(slot_pos), pos,
                                    window=window, n_sink=sink, **tkw)
    model_path = jattn.decode_attention(*jargs, jnp.asarray(slot_pos),
                                        jnp.asarray(pos, jnp.int32),
                                        window=window, n_sink=sink, **jkw)
    pallas = decode_attention_pallas(*jargs, jnp.asarray(slot_pos),
                                     jnp.asarray(pos, jnp.int32),
                                     window=window, n_sink=sink,
                                     block_s=32 if s % 64 else 64,
                                     interpret=True,
                                     **jkw)
    tol = dict(rtol=BF16_ULP, atol=1e-3) if kind == "bfloat16" else \
        dict(rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(f32(out), f32(pallas), **tol)
    np.testing.assert_allclose(f32(out), f32(model_path), **tol)


def test_decode_attention_ref_ring_with_empty_slots_and_no_visible_row():
    b, s, h, d = 2, 64, 2, 64
    q, kc, vc = _decode_inputs(b, s, h, h, d, seed=9)
    # a ring: slots 0..31 hold positions 64..95, 32..47 hold 48..63, the
    # rest are empty
    slot_pos = np.full(s, -1, np.int32)
    slot_pos[:32] = np.arange(64, 96)
    slot_pos[32:48] = np.arange(48, 64)
    args = [torch.from_numpy(a) for a in (q, kc, vc, slot_pos)]
    jargs = [jnp.asarray(a) for a in (q, kc, vc, slot_pos)]
    for pos, window in ((95, None), (95, 20), (70, None)):
        out = tref.decode_attention_ref(*args, pos, window=window)
        want = jattn.decode_attention(*jargs, jnp.asarray(pos, jnp.int32),
                                      window=window)
        pallas = decode_attention_pallas(*jargs, jnp.asarray(pos, jnp.int32),
                                         window=window, block_s=32,
                                         interpret=True)
        for other in (want, pallas):
            np.testing.assert_allclose(out.numpy(), np.asarray(other),
                                       rtol=F32_TOL, atol=F32_TOL)
    # nothing visible (every stored position is past pos): 0, as the Pallas
    # kernel's l = max(l, 1e-30) gives (the jnp path's softmax would
    # average the invisible slots instead)
    out = tref.decode_attention_ref(*args, 40)
    pallas = decode_attention_pallas(*jargs, jnp.asarray(40, jnp.int32),
                                     block_s=32, interpret=True)
    assert np.all(out.numpy() == 0.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(pallas))


@pytest.mark.parametrize("quantized", [False, True])
def test_init_kv_cache_defaults_to_cuda(monkeypatch, quantized):
    """``device=None`` resolves to CUDA, as at every entry point: without
    CUDA it raises; ``device="cpu"`` gives the JAX package's empty caches."""
    args = (2, 3, 8, 2, 16)
    jc = jattn.init_kv_cache(*args, dtype=jnp.float32, quantized=quantized)
    tc = tattn.init_kv_cache(*args, dtype=torch.float32, quantized=quantized,
                             device="cpu")
    names = ("k", "v", "slot_pos") + (("k_scale", "v_scale") if quantized
                                      else ())
    for name in names:
        j, t = getattr(jc, name), getattr(tc, name)
        assert t.device.type == "cpu" and str(t.dtype) == f"torch.{j.dtype}"
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tc.pos == 0 and tc.quantized == quantized
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tattn.init_kv_cache(*args, quantized=quantized)


def test_attention_ops_refuse_what_the_kernels_do_not_take():
    """The CPU path holds the kernels' contracts, so what the card would
    refuse is refused here too."""
    q, k, v = map(torch.from_numpy, _qkv(1, 8, 8, 4, 2, 48, seed=0))
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, k, v)
    q, k, v = map(torch.from_numpy, _qkv(1, 8, 8, 4, 2, 64, seed=0))
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        ops.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                            k, v)
    # a contiguous view 4 bytes past an aligned start
    shifted = torch.cat([k.flatten()[:1], k.flatten()])[1:].reshape(k.shape)
    with pytest.raises(ValueError, match="16-byte boundary"):
        ops.flash_attention(q, shifted, v)
    q1, kc, vc = map(torch.from_numpy, _decode_inputs(1, 16, 34, 2, 64, 0))
    sp = torch.arange(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="H/HKV"):
        ops.decode_attention(q1, kc, vc, sp, 15)
    q1, kc, vc = map(torch.from_numpy, _decode_inputs(1, 16, 4, 2, 64, 0))
    with pytest.raises(ValueError, match="int8 caches need"):
        ops.decode_attention(q1, kc.to(torch.int8), vc.to(torch.int8), sp,
                             15)
    with pytest.raises(ValueError, match="slot_pos"):
        ops.decode_attention(q1, kc, vc, sp.long(), 15)


# --------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------- #
def _tokens(vocab, b, l, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, l)).astype(
        np.int32)


def _check_caches(jc, tc, tol, ssm_tol=None):
    """KV caches within ``tol``, slot positions and position exactly; SSM
    states (f32) within ``ssm_tol``, or, where it is None (a bf16 model),
    within ``BF16_MODEL_REL`` of each state's largest magnitude, as bf16
    logits are held: the states sum bf16 projections whose rounding flips
    between the packages over every position."""
    assert (tc.kv is None) == (jc.kv is None)
    assert (tc.ssm is None) == (jc.ssm is None)
    if tc.kv is not None:
        for name in ("k", "v"):
            np.testing.assert_allclose(f32(getattr(tc.kv, name)),
                                       f32(getattr(jc.kv, name)), **tol)
        assert np.array_equal(tc.kv.slot_pos.numpy(),
                              np.asarray(jc.kv.slot_pos))
        assert tc.kv.pos == int(jc.kv.pos)
    if tc.ssm is not None:
        for name in ("conv", "ssd"):
            t, j = getattr(tc.ssm, name), getattr(jc.ssm, name)
            assert t.dtype == torch.float32 and t.shape == j.shape
            j = np.asarray(j)
            np.testing.assert_allclose(t.numpy(), j, **(ssm_tol or dict(
                rtol=0, atol=BF16_MODEL_REL * np.abs(j).max())))


def _logit_tol(jcfg, ref):
    if jcfg.dtype == "bfloat16":
        return dict(rtol=0, atol=BF16_MODEL_REL * float(np.abs(ref).max()))
    return dict(rtol=0, atol=F32_TOL)


def _same_greedy(jlogits: np.ndarray, tlogits: np.ndarray, where: str,
                 tie_tol: float = TIE_TOL):
    """Greedy tokens equal, except where the JAX logits' top-two gap is
    under ``tie_tol`` (reported). Returns the near-ties found."""
    jl = jlogits.reshape(-1, jlogits.shape[-1])
    tl = tlogits.reshape(-1, tlogits.shape[-1])
    top2 = np.sort(jl, axis=-1)[:, -2:]
    ties = top2[:, 1] - top2[:, 0] < tie_tol
    differ = jl.argmax(-1) != tl.argmax(-1)
    assert not np.any(differ & ~ties), f"{where}: greedy tokens differ"
    if np.any(ties):
        print(f"{where}: {int(ties.sum())} near-tie(s) (top-two gap < "
              f"{tie_tol}); logits compared only")
    return int(ties.sum())


# SSM states (f32): the scan's sums run in other orders, over states of
# magnitude up to ~20 (measured: 3e-5 after four decode steps)
SSM_STATE_TOL = dict(rtol=1e-5, atol=1e-4)


def model_matches_jax(arch, bf16_small, *, cfgs=None, toks=None,
                      cache_size=None, steps=8):
    """Logits and prefill caches of ``forward``, then ``steps``
    ``decode_step``s fed JAX's greedy tokens, against the JAX ``Model``
    with the same weights (``cfgs``: a (JAX, port) config pair in place of
    ``configs(arch, bf16_small)``). Returns the two models' last caches."""
    jcfg, tcfg = cfgs or configs(arch, bf16_small)
    jm, params, tm = models(jcfg, tcfg)
    if toks is None:
        toks = _tokens(jcfg.vocab, 3, 16, seed=2)
    cache_size = cache_size or toks.shape[1] + jcfg.n_meta_tokens + 8 + 2
    jl, jc, _ = jm.forward(params, jnp.asarray(toks), collect_cache=True,
                           cache_size=cache_size)
    with torch.inference_mode():
        tl, tc = tm(torch.from_numpy(toks).long(), collect_cache=True,
                    cache_size=cache_size)
    jl = f32(jl)
    tol = _logit_tol(jcfg, jl)
    np.testing.assert_allclose(f32(tl), jl, **tol)
    cache_tol = dict(rtol=0, atol=F32_TOL) if jcfg.dtype == "float32" else \
        dict(rtol=2 * BF16_ULP, atol=0.05)
    ssm_tol = SSM_STATE_TOL if jcfg.dtype == "float32" else None
    _check_caches(jc, tc, cache_tol, ssm_tol)
    tie_tol = 2 * np.abs(f32(tl) - jl).max() if bf16_small else TIE_TOL
    _same_greedy(jl, f32(tl), f"{jcfg.name} forward", tie_tol)
    nt = jl[:, -1:].argmax(-1)
    decode = jax.jit(jm.decode_step)
    for step in range(steps):
        jd, jc = decode(params, jc, jnp.asarray(nt))
        with torch.inference_mode():
            td, tc = tm.decode_step(tc, torch.from_numpy(nt).long())
        jd = f32(jd)
        tol = _logit_tol(jcfg, jd)
        np.testing.assert_allclose(f32(td), jd, **tol)
        _check_caches(jc, tc, cache_tol, ssm_tol)
        tie_tol = 2 * np.abs(f32(td) - jd).max() if bf16_small else TIE_TOL
        _same_greedy(jd, f32(td), f"{jcfg.name} decode step {step}", tie_tol)
        nt = jd.argmax(-1)
    return jc, tc


@pytest.mark.parametrize("arch,bf16_small", [(a, False) for a in DENSE]
                         + [("yi-6b", True)])
def test_model_forward_and_decode_match_jax(arch, bf16_small):
    model_matches_jax(arch, bf16_small)


def test_ring_prefill_and_int8_decode_match_jax():
    """A prefill longer than the cache (the ring branch of
    ``_build_prefill_caches``) and decoding from int8 caches."""
    jcfg, tcfg = configs("yi-6b")
    jm, params, tm = models(jcfg, tcfg)
    toks = _tokens(jcfg.vocab, 2, 20, seed=3)
    _, jc, _ = jm.forward(params, jnp.asarray(toks), collect_cache=True,
                          cache_size=12)
    with torch.inference_mode():
        _, tc = tm(torch.from_numpy(toks).long(), collect_cache=True,
                   cache_size=12)
    _check_caches(jc, tc, dict(rtol=0, atol=F32_TOL))
    nt = np.ones((2, 1), np.int32)
    jq = jm.init_decode_caches(2, 16, kv_quantized=True)
    tq = tm.init_decode_caches(2, 16, kv_quantized=True)
    for step in range(20):   # past the 16-slot ring
        jd, jq = jm.decode_step(params, jq, jnp.asarray(nt))
        with torch.inference_mode():
            td, tq = tm.decode_step(tq, torch.from_numpy(nt).long())
        np.testing.assert_allclose(f32(td), f32(jd), rtol=0,
                                   atol=INT8_KV_TOL)
        np.testing.assert_allclose(tq.kv.k_scale.numpy(),
                                   np.asarray(jq.kv.k_scale), rtol=1e-5,
                                   atol=1e-7)
        assert np.array_equal(tq.kv.slot_pos.numpy(),
                              np.asarray(jq.kv.slot_pos))
        nt = f32(jd).argmax(-1)


def decode_matches_own_forward(arch):
    """Prefill -> decode equals the forward of the extended sequence, as
    ``tests/test_arch_smoke.py`` checks for JAX."""
    _, tcfg = configs(arch)
    tm = Model(tcfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(tcfg.vocab, 2, 24, seed=4)).long()
    with torch.inference_mode():
        lg, caches = tm(toks, collect_cache=True, cache_size=64)
        nt = lg[:, -1:].argmax(-1)
        dl, _ = tm.decode_step(caches, nt)
        lg2 = tm(torch.cat([toks, nt], dim=1))
        last = tm(toks, logits_last_only=True)
    assert float((dl[:, 0] - lg2[:, -1]).abs().max()) < F32_TOL
    assert last.shape == (2, 1, tcfg.padded_vocab)
    assert float((last - lg[:, -1:]).abs().max()) < F32_TOL


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_own_forward(arch):
    decode_matches_own_forward(arch)


def test_params_from_jax_keeps_every_leaf_and_dtype():
    jcfg, tcfg = configs("yi-6b", bf16_small=True)
    jm = JModel(jcfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init_params(jax.random.PRNGKey(1)))
    state = params_from_jax(params)
    tm = Model(tcfg, device="cpu")
    assert set(state) == set(tm.state_dict())
    tm.load_state_dict(state)
    for name, t in tm.state_dict().items():
        top, _, sub = name.partition(".")
        leaf = params[top][sub] if sub else params[top]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).removeprefix("torch.") == leaf.dtype.name
        assert np.array_equal(f32(t), leaf.astype(np.float32))
    assert to_tensor(np.arange(3, dtype=np.int32)).dtype == torch.int32


def test_init_params_scales_and_generator():
    _, tcfg = configs("yi-6b")
    a = Model(tcfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    b = Model(tcfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    d = tcfg.d_model
    assert abs(float(a.blocks["wq"].std()) - d ** -0.5) < 0.1 * d ** -0.5
    assert abs(float(a.embed.std()) - 0.02) < 0.002
    assert bool(torch.all(a.blocks["norm1"] == 1.0))


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_each_arch_runs_or_names_its_slice(arch):
    """The dense, moe, ssm and hybrid families build and run a reduced
    forward; audio and vlm raise, naming the slice that brings them."""
    cfg = get_arch(arch).reduced()
    if cfg.arch_type in ("audio", "vlm"):
        with pytest.raises(NotImplementedError,
                           match=f"{cfg.arch_type} slice"):
            Model(cfg, device="cpu")
        return
    m = Model(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    assert m.config is cfg
    toks = torch.from_numpy(_tokens(cfg.vocab, 2, 5, seed=1)).long()
    with torch.inference_mode():
        logits = m(toks)
    assert logits.shape == (2, 5, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(get_arch("yi-6b").reduced())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.build(corpus=2, queries=1, backend="model")


def test_cuda_prefill_with_sinks_goes_to_the_kernel(monkeypatch):
    """``ops`` sends a CUDA prefill with sinks (``n_sink > 0``) to the
    hand-written kernel's wrapper, never to the plain version: a stand-in
    for a CUDA tensor shows the route without a card. ``n_sink < 0`` is
    refused on both routes."""
    class OnCuda:
        device = torch.device("cuda")
    calls = []
    monkeypatch.setattr(kflash, "flash_attention_cuda",
                        lambda *a, **kw: calls.append(kw) or "kernel")
    monkeypatch.setattr(tref, "flash_attention_ref",
                        lambda *a, **kw: pytest.fail("plain version called"))
    q = OnCuda()
    assert ops.flash_attention(q, q, q, window=16, n_sink=4) == "kernel"
    assert calls == [dict(causal=True, window=16, n_sink=4, scale=None)]
    monkeypatch.undo()
    q, k, v = map(torch.from_numpy, _qkv(1, 8, 8, 4, 2, 64, seed=0))
    with pytest.raises(ValueError, match="n_sink"):
        ops.flash_attention(q, k, v, window=4, n_sink=-1)
    with pytest.raises(ValueError, match="n_sink"):
        kflash.flash_attention_cuda(q, k, v, window=4, n_sink=-1)


# --------------------------------------------------------------------- #
# the backend and the serve launcher
# --------------------------------------------------------------------- #
QUERIES = ["how do I reset my router", "what is a python list",
           "where is my order", "can I return shoes bought online",
           "why is my wifi slow at night", "how to sort a dict by value"]


def _greedy_trace(jm, params, tm, toks, steps):
    """Prefill (cache 96) then ``steps`` decode steps on both models, both
    fed JAX's greedy token; returns the per-step JAX and port logits."""
    jl, jc, _ = jm.forward(params, jnp.asarray(toks), collect_cache=True,
                           cache_size=96)
    with torch.inference_mode():
        tl, tc = tm(torch.from_numpy(toks).long(), collect_cache=True,
                    cache_size=96)
    out = [(f32(jl)[:, -1:], f32(tl)[:, -1:])]
    decode = jax.jit(jm.decode_step)
    for _ in range(steps):
        nt = out[-1][0].argmax(-1)
        jd, jc = decode(params, jc, jnp.asarray(nt))
        with torch.inference_mode():
            td, tc = tm.decode_step(tc, torch.from_numpy(nt).long())
        out.append((f32(jd), f32(td)))
    return out


def test_model_backend_generate_matches_jax():
    jcfg, tcfg = configs("yi-6b")
    jm, params, tm = models(jcfg, tcfg)
    jb = JModelBackend(jm, params, JTokenizer(vocab_size=jcfg.vocab))
    tb = ModelBackend(tm, HashTokenizer(vocab_size=tcfg.vocab))
    jres = jb.generate(QUERIES)
    tres = tb.generate(QUERIES)
    assert tb.calls == jb.calls == len(QUERIES)
    assert tres.cost_usd == 0.0 and tres.latency_s > 0
    toks, _ = tb.tokenizer.encode_batch(QUERIES, tb.max_prompt_len)
    trace = _greedy_trace(jm, params, tm, toks, tb.max_new_tokens - 1)
    ties = np.zeros(len(QUERIES), bool)
    for step, (jl, tl) in enumerate(trace):
        np.testing.assert_allclose(tl, jl, rtol=0, atol=F32_TOL)
        top2 = np.sort(jl[:, 0], axis=-1)[:, -2:]
        near = top2[:, 1] - top2[:, 0] < TIE_TOL
        differ = jl[:, 0].argmax(-1) != tl[:, 0].argmax(-1)
        assert not np.any(differ & ~near), f"greedy token differs, step {step}"
        ties |= near
    for i, (a, b) in enumerate(zip(jres.answers, tres.answers)):
        if ties[i]:
            print(f"query {i}: a near-tie in JAX's logits; answers not "
                  "compared, logits compared above")
            continue
        assert a == b, (i, a, b)


def jax_serve(arch, corpus, queries, batch, jparams):
    """``repro.launch.serve --backend model --arch <arch>`` (reduced),
    built as its ``main`` builds it, with the given weights."""
    pairs = build_corpus(corpus, seed=0)
    tests = build_test_queries(pairs, n_per_category=queries, seed=1)
    by_id = {p.qa_id: p for p in pairs}

    def judge(req, sid):
        return sid >= 0 and sid in by_id and \
            by_id[sid].semantic_key == req.semantic_key
    cfg = jget_arch(arch).reduced()
    backend = JModelBackend(JModel(cfg), jparams,
                            JTokenizer(vocab_size=cfg.vocab))
    engine = JEngine(JConfig(dim=384, capacity=max(16384, 8 * corpus),
                             value_len=48, threshold=0.8), backend,
                     judge=judge, batch_size=batch)
    engine.warm(pairs)
    reqs = [JRequest(query=q.query, category=q.category,
                     source_id=q.source_id, semantic_key=q.semantic_key)
            for q in tests]
    return engine, engine.process(reqs)


def serve_matches_jax(arch):
    """``launch.serve --backend model --arch <arch> --device cpu`` with
    JAX's weights gives ``repro.launch.serve``'s hits and answers request
    by request."""
    kw = dict(corpus=20, queries=5, batch=16)
    jparams = jax.jit(JModel(jget_arch(arch).reduced()).init_params)(
        jax.random.PRNGKey(0))
    jeng, jresp = jax_serve(arch, jparams=jparams, **kw)
    teng, treq = serve.build(device="cpu", backend="model", arch=arch,
                             log=lambda *a: None, **kw)
    teng.backend.model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    tresp = teng.process(treq)
    assert len(tresp) == len(jresp) == 20
    assert any(not r.cached for r in tresp) and any(r.cached for r in tresp)
    for i, (j, t) in enumerate(zip(jresp, tresp)):
        assert (t.cached, t.answer) == (j.cached, j.answer), i
        assert abs(t.score - j.score) <= 1e-5, i
    js, ts = jeng.metrics.summary(), teng.metrics.summary()
    for cat, m in js["categories"].items():
        for field in ("lookups", "cache_hits", "positive_hits"):
            assert ts["categories"][cat][field] == m[field], (cat, field)
    assert teng.backend.calls == jeng.backend.calls


def test_serve_backend_model_matches_jax_serve():
    serve_matches_jax("yi-6b")


def test_serve_cli_backend_model_runs_on_cpu(capsys):
    serve.main(["--device", "cpu", "--backend", "model", "--corpus", "10",
                "--queries", "3", "--batch", "8"])
    assert '"categories"' in capsys.readouterr().out


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch or raise; CPU tensors go to the plain
    versions through ``ops`` only."""
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q, k, v = map(torch.from_numpy, _qkv(1, 8, 8, 4, 2, 64, seed=0))
    with pytest.raises(RuntimeError, match="takes CUDA tensors"):
        flash_attention_cuda(q, k, v)
    q1, kc, vc = map(torch.from_numpy, _decode_inputs(1, 16, 4, 2, 64, 0))
    with pytest.raises(RuntimeError, match="takes CUDA tensors"):
        decode_attention_cuda(q1, kc, vc, torch.arange(16, dtype=torch.int32),
                              15)
