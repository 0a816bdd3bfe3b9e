"""The hybrid family on the CPU: prefill and decode attention with sinks
(the plain versions the card's kernels are held to) and the reduced
hymba-1.5b ``Model`` (meta tokens, per-layer windows, the fused attention
and SSM branches, the KV ring and SSM states, decode steps, the serve
driver) against the JAX package, on inputs made with numpy from a seed
and weights carried across with ``convert.params_from_jax``.

Tolerances as ``test_torch_models.py`` states them (``F32_TOL`` on f32
outputs and logits, ``BF16_MODEL_REL`` on bf16 logits, greedy tokens
equal but at near-ties); SSM states within ``SSM_STATE_TOL``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import model as tmodel
from test_torch_models import (F32_TOL, _decode_inputs, _qkv, _tokens,
                               configs, decode_matches_own_forward,
                               model_matches_jax, serve_matches_jax)

SINK_CASES = [  # (B, Lq, Lk, H, HKV, D, window, n_sink)
    (2, 96, 96, 4, 2, 64, 32, 8),        # n_sink < one 64-key tile
    (1, 200, 200, 5, 1, 64, 48, 100),    # sinks span tiles, not a multiple
    (1, 130, 130, 6, 1, 64, 40, 200),    # n_sink >= Lk: every key a sink
    (2, 64, 192, 10, 2, 64, 50, 70),     # Lk > Lq with sinks, G=5
    (1, 150, 150, 12, 2, 128, 30, 64),   # G=6, D=128, sinks one whole tile
    (2, 72, 72, 4, 2, 64, 64, 8),        # hymba reduced: 8 meta + 64 text
    (2, 40, 40, 5, 1, 64, None, 16),     # no window: sinks change nothing
]


@pytest.mark.parametrize("b,lq,lk,h,hkv,d,window,n_sink", SINK_CASES)
def test_flash_attention_with_sinks_matches_jax(b, lq, lk, h, hkv, d,
                                                window, n_sink):
    """``ops.flash_attention`` with sinks (the CPU route: the plain version
    the card's kernel is held to) against JAX's model-path
    ``blockwise_attention``, whose pruned block ranges take the sinks
    apart from the window; windows that drop keys on most rows."""
    q, k, v = _qkv(b, lq, lk, h, hkv, d, seed=lq + n_sink)
    out = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              window=window, n_sink=n_sink).numpy()
    want = jattn.blockwise_attention(*map(jnp.asarray, (q, k, v)),
                                     window=window, n_sink=n_sink,
                                     block_q=32, block_k=32)
    np.testing.assert_allclose(out, np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    if window is not None and n_sink < lk:   # the sinks are seen
        plain = tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                         window=window)
        assert float(np.abs(plain.numpy() - out).max()) > 1e-3


@pytest.mark.parametrize("b,s,h,hkv,window,n_sink", [
    (3, 96, 5, 1, 1024, 128),    # hymba's serve ring, meta tokens 96-127
    (2, 64, 10, 2, 20, 8),       # G=5, a window that drops keys
    (2, 80, 12, 2, 16, 40),      # G=6
])
def test_decode_attention_with_sinks_matches_jax(b, s, h, hkv, window,
                                                 n_sink):
    """A ring holding the last S positions, sinks among them: slot i holds
    position ``pos - (pos - i) % S``."""
    q, kc, vc = _decode_inputs(b, s, h, hkv, 64, seed=s + h)
    pos = 2 * s + 3
    slot_pos = (pos - (pos - np.arange(s)) % s).astype(np.int32)
    if n_sink >= s:   # hymba: positions 96..191 after a 192-token prefill
        pos, slot_pos = 191, np.arange(96, 192, dtype=np.int32)
    else:             # the sinks' slots kept: positions 0..n_sink-1
        slot_pos[:n_sink] = np.arange(n_sink)
    out = ops.decode_attention(*map(torch.from_numpy, (q, kc, vc, slot_pos)),
                               pos, window=window, n_sink=n_sink)
    want = jattn.decode_attention(*map(jnp.asarray, (q, kc, vc, slot_pos)),
                                  jnp.asarray(pos, jnp.int32), window=window,
                                  n_sink=n_sink)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_hymba_layers_window_and_meta_tokens():
    """Global attention on every 8th layer, the window elsewhere; the
    meta tokens lead at positions 0..n_meta-1 and the text is shifted."""
    _, tcfg = configs("hymba-1.5b")
    m = tmodel.Model(tcfg, device="cpu")
    assert [w for *_, w in m._layers()] == [None, 64]
    full = tmodel.Model(dataclasses.replace(tcfg, n_layers=17), device="cpu")
    wins = [w for *_, w in full._layers()]
    assert [i for i, w in enumerate(wins) if w is None] == [0, 8, 16]
    x = torch.zeros((2, 5, tcfg.d_model))
    m.meta_tokens = torch.nn.Parameter(torch.ones((8, tcfg.d_model)),
                                       requires_grad=False)
    x, pos, n_lead = m._prepend_context(
        x, torch.arange(5, dtype=torch.int32).expand(2, 5))
    assert n_lead == 8 and x.shape == (2, 13, tcfg.d_model)
    assert pos[0].tolist() == list(range(13))
    assert bool((x[:, :8] == 1).all()) and not x[:, 8:].any()


@pytest.mark.parametrize("bf16_small", [False, True])
def test_hymba_model_matches_jax(bf16_small):
    """The reduced hymba (f32; 8 meta tokens, window 64) and its published
    geometry in bf16 at a small width (128 meta tokens, 25/5 heads of
    64): logits, KV caches and SSM states through 8 decode steps."""
    jc, tc = model_matches_jax("hymba-1.5b", bf16_small)
    assert tc.kv is not None and tc.ssm is not None


def test_hymba_ring_drops_meta_tokens_as_jax_does():
    """An 80-token prompt behind 8 meta tokens (88 positions) into a
    cache of 84: the ring keeps positions 4..87, so meta tokens 0-3 are
    gone and 4-7 stay as sinks past the 64-key window; decode step i
    writes position 88 + i over meta token 4 + i, so the first steps see
    the rest. The reference does this, and so does the port
    (``ModelBackend``'s 96 slots behind hymba's 128 meta tokens and
    64-token prompts are the serve path's case)."""
    jcfg, _ = configs("hymba-1.5b")
    toks = _tokens(jcfg.vocab, 2, 80, seed=6)
    jc, tc = model_matches_jax("hymba-1.5b", False, toks=toks,
                               cache_size=84, steps=4)
    slots = tc.kv.slot_pos.numpy()
    assert tc.kv.pos == 88 + 4 and slots[4:8].tolist() == [88, 89, 90, 91]
    assert sorted(slots.tolist()) == list(range(8, 92))


def test_hymba_decode_continues_forward():
    decode_matches_own_forward("hymba-1.5b")


def test_hymba_serve_matches_jax_serve():
    serve_matches_jax("hymba-1.5b")
