"""Row 8's log-sum-exp on the CPU: ``ops.decode_attention(...,
return_lse=True)`` (the plain version's route) against a float64 numpy
log-sum-exp of the same scores, and a cache cut into 2 and 4 slot ranges,
each range's part merged by ``models.attention.merge_lse``, against the
JAX package's ``decode_attention``: f32 and int8 caches, a window with
sinks, a range that sees no slot, and a row that sees none (against the
Pallas kernel in interpret mode: 0, where the jnp path averages). Inputs
from numpy; the lse within 1e-5 with ``-inf`` in the same places, merged
outputs within 1e-5 of the largest output."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention_pallas
from repro.models import attention as jattn
from repro_torch.kernels import ops
from repro_torch.models.attention import merge_lse, quantize_kv

TOL = 1e-5
B, S, H, HKV, D = 3, 64, 8, 2, 64
# (name, window, n_sink, int8, ring, pos): slots hold positions 0..S-1,
# "ring" leaves slots 32.. empty (with 2 or 4 ranges, whole ranges see
# nothing); pos -1 sees no slot at all
CASES = (("prefix", None, 0, False, False, 50),
         ("int8", None, 0, True, False, 63),
         ("window_sinks", 16, 4, False, False, 63),
         ("window_sinks_int8", 16, 4, True, False, 63),
         ("ring", None, 0, False, True, 31),
         ("none", None, 0, False, False, -1))


def inputs(name, int8, ring):
    rng = np.random.default_rng(sum(map(ord, name)))
    q = (rng.standard_normal((B, 1, H, D)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((B, S, HKV, D)) * 0.3).astype(np.float32)
    v = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    t = dict(q=torch.from_numpy(q), k=torch.from_numpy(k),
             v=torch.from_numpy(v), k_scale=None, v_scale=None)
    if int8:
        t["k"], t["k_scale"] = quantize_kv(t["k"])
        t["v"], t["v_scale"] = quantize_kv(t["v"])
    sp = np.arange(S, dtype=np.int32)
    if ring:
        sp = np.where(sp < 32, sp, -1).astype(np.int32)
    t["slot_pos"] = torch.from_numpy(sp)
    return t


def numpy_lse(t, window, sink, pos):
    """(B, H) float64 log-sum-exp of the scaled scores over the visible
    slots, -inf where none is."""
    k = t["k"].numpy().astype(np.float64)
    if t["k_scale"] is not None:
        k = k * t["k_scale"].numpy()[..., None]
    q = t["q"].numpy().astype(np.float64).reshape(B, HKV, H // HKV, D)
    s = np.einsum("bhgd,bshd->bhgs", q, k) / np.sqrt(D)
    sp = t["slot_pos"].numpy()
    visible = (sp >= 0) & (sp <= pos)
    if window is not None:
        visible &= (sp > pos - window) | (sp < sink)
    s = np.where(visible, s, -np.inf)
    m = s.max(-1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        lse = np.where(np.isfinite(m[..., 0]), (m + np.log(np.exp(
            s - np.where(np.isfinite(m), m, 0.0)).sum(-1, keepdims=True)))[
            ..., 0], -np.inf)
    return lse.reshape(B, H)


def call(t, lo, hi, pos, window, sink, **kw):
    def cut(x):
        return None if x is None else x[:, lo:hi].contiguous()
    return ops.decode_attention(
        t["q"], cut(t["k"]), cut(t["v"]), t["slot_pos"][lo:hi].contiguous(),
        pos, window=window, n_sink=sink, k_scale=cut(t["k_scale"]),
        v_scale=cut(t["v_scale"]), **kw)


def jax_reference(t, window, sink, pos):
    args = [jnp.asarray(t[n].numpy()) for n in ("q", "k", "v", "slot_pos")]
    kw = dict(window=window, n_sink=sink)
    if t["k_scale"] is not None:
        kw.update(k_scale=jnp.asarray(t["k_scale"].numpy()),
                  v_scale=jnp.asarray(t["v_scale"].numpy()))
    if pos < 0:     # nothing visible: the Pallas kernel's 0
        return np.asarray(decode_attention_pallas(
            *args, jnp.asarray(pos, jnp.int32), block_s=32, interpret=True,
            **kw))
    return np.asarray(jattn.decode_attention(
        *args, jnp.asarray(pos, jnp.int32), **kw))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_plain_lse_matches_numpy(case):
    name, window, sink, int8, ring, pos = case
    t = inputs(name, int8, ring)
    out, lse = call(t, 0, S, pos, window, sink, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    want = numpy_lse(t, window, sink, pos)
    assert np.array_equal(np.isinf(lse.numpy()), np.isinf(want))
    assert not np.isnan(lse.numpy()).any()
    fin = np.isfinite(want)
    np.testing.assert_allclose(lse.numpy()[fin], want[fin], rtol=0, atol=TOL)
    # the output beside it is the output without it, bit for bit
    assert out.dtype == t["q"].dtype
    assert torch.equal(out, call(t, 0, S, pos, window, sink))


@pytest.mark.parametrize("n_ranges", [2, 4])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_slot_ranges_merged_by_lse_equal_jax(case, n_ranges):
    name, window, sink, int8, ring, pos = case
    t = inputs(name, int8, ring)
    cuts = [i * S // n_ranges for i in range(n_ranges + 1)]
    parts = [call(t, lo, hi, pos, window, sink, return_lse=True)
             for lo, hi in zip(cuts, cuts[1:])]
    lses = torch.stack([x for _, x in parts])
    if ring:    # the ranges past slot 32 see nothing
        assert bool(torch.isinf(lses[n_ranges // 2:]).all())
    got = merge_lse(torch.stack([o for o, _ in parts]), lses,
                    lambda x, op: x.amax(0) if op == "max" else x.sum(0))
    want = jax_reference(t, window, sink, pos)
    assert got.shape == want.shape and got.dtype == torch.float32
    if pos < 0:
        assert not got.numpy().any() and not want.any()
        return
    whole = call(t, 0, S, pos, window, sink).numpy()
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= TOL * scale
    assert np.abs(got.numpy() - whole).max() <= TOL * scale


def test_decode_with_lse_refuses_grad():
    t = inputs("prefix", False, False)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.decode_attention(t["q"].requires_grad_(), t["k"], t["v"],
                             t["slot_pos"], 10, return_lse=True)
