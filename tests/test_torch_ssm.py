"""The ssm family on the CPU: the port's ``models/ssm.py`` (the causal
conv, the segment-sum decay, the chunked SSD scan, the layer's forward
with its decode-continuation states and its one-token step) and the
reduced mamba2-130m ``Model`` (forward, SSM states, decode steps, the
serve driver) against the JAX package, on inputs made with numpy from a
seed and weights carried across with ``convert.params_from_jax``.

Tolerances: 1e-5 on the layer's pieces (f32 sums in other orders); the
model as ``test_torch_models.py`` states it, its SSM states within
``SSM_STATE_TOL``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import ssm as jssm
from repro_torch.configs import get_arch
from repro_torch.models import ssm as tssm
from test_torch_models import (decode_matches_own_forward, model_matches_jax,
                               serve_matches_jax)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_causal_conv1d_and_segsum_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    np.testing.assert_allclose(tssm.causal_conv1d(*_t(x, w, b)).numpy(),
                               np.asarray(jssm.causal_conv1d(*_j(x, w, b))),
                               **TOL)
    # a decaying cumulative sum, as the scan forms it: the entries above
    # the diagonal overflow exp (diff up to 120) and must come out 0
    a_cum = np.cumsum(-np.abs(rng.standard_normal((2, 3, 40))) * 3.0,
                      axis=-1).astype(np.float32)
    got = tssm._segsum_exp(torch.from_numpy(a_cum)).numpy()
    np.testing.assert_allclose(got, np.asarray(jssm._segsum_exp(
        jnp.asarray(a_cum))), **TOL)
    assert np.all(np.isfinite(got)) and np.all(np.triu(got, 1) == 0)


def _scan_inputs(b, l, h, p, g, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    bm = rng.standard_normal((b, l, g, n)).astype(np.float32) * 0.5
    cm = rng.standard_normal((b, l, g, n)).astype(np.float32) * 0.5
    d = rng.standard_normal(h).astype(np.float32)
    return x, dt, a, bm, cm, d


@pytest.mark.parametrize("l,chunk,with_state", [(40, 16, False),
                                                (37, 16, True),
                                                (12, 32, False)])
def test_ssd_scan_matches_jax(l, chunk, with_state):
    """L a chunk multiple or not (padded with dt = 0 rows), one chunk
    shorter than the chunk size, and an initial state."""
    args = _scan_inputs(2, l, 4, 8, 2, 6, seed=l)
    init = np.random.default_rng(1).standard_normal((2, 4, 8, 6)).astype(
        np.float32) if with_state else None
    ty, ts = tssm.ssd_scan(*_t(*args), chunk,
                           init_state=None if init is None
                           else torch.from_numpy(init))
    jy, js = jssm.ssd_scan(*_j(*args), chunk,
                           init_state=None if init is None
                           else jnp.asarray(init))
    assert ty.shape == (2, l, 4, 8) and ts.shape == (2, 4, 8, 6)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


def _layer(arch, seed):
    """One SSM layer's JAX parameters (random biases and ``a_log``, not
    the init's zeros) as numpy, and the reduced config."""
    jcfg = jget_arch(arch).reduced()
    params = jssm.init_ssm_params(jax.random.PRNGKey(seed), jcfg,
                                  jnp.float32)
    params = {k: np.array(v) for k, v in params.items()}
    rng = np.random.default_rng(seed)
    for name in ("conv_b", "dt_bias", "a_log"):
        params[name] = (rng.standard_normal(params[name].shape) * 0.3
                        ).astype(np.float32)
    return jcfg, get_arch(arch).reduced(), params


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
@pytest.mark.parametrize("l", [2, 45])
def test_ssm_forward_and_decode_match_jax(arch, l):
    """``ssm_forward(return_state=True)`` (a prefill shorter than the conv
    window, and one past a chunk), then three ``ssm_decode_step``s from
    its states, each against JAX's."""
    jcfg, tcfg, params = _layer(arch, seed=l)
    rng = np.random.default_rng(l + 1)
    x = rng.standard_normal((2, l, jcfg.d_model)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jy, jconv, jssd = jssm.ssm_forward(jp, jnp.asarray(x), jcfg,
                                       return_state=True)
    ty, tconv, tssd = tssm.ssm_forward(tp, torch.from_numpy(x), tcfg,
                                       return_state=True)
    for t, j in ((ty, jy), (tconv, jconv), (tssd, jssd)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    assert tconv.shape == (2, tcfg.ssm_conv - 1, tssm.ssm_dims(tcfg)[
        "conv_dim"]) and tconv.dtype == torch.float32
    assert tssm.ssm_forward(tp, torch.from_numpy(x), tcfg).shape == x.shape
    for step in range(3):
        x1 = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jy, jconv, jssd = jssm.ssm_decode_step(jp, jnp.asarray(x1), jconv,
                                               jssd, jcfg)
        ty, tconv, tssd = tssm.ssm_decode_step(tp, torch.from_numpy(x1),
                                               tconv, tssd, tcfg)
        for t, j in ((ty, jy), (tconv, jconv), (tssd, jssd)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_init_ssm_state_matches_jax():
    jcfg, tcfg = jget_arch("mamba2-130m").reduced(), \
        get_arch("mamba2-130m").reduced()
    js = jssm.init_ssm_state(jcfg, 3)
    ts = tssm.init_ssm_state(tcfg, 3, "cpu")
    for name in ("conv", "ssd"):
        t, j = getattr(ts, name), getattr(js, name)
        assert t.dtype == torch.float32 and t.shape == j.shape
        assert not t.any()


@pytest.mark.parametrize("bf16_small", [False, True])
def test_mamba2_model_matches_jax(bf16_small):
    """The reduced mamba2 (f32) and its published SSM geometry in bf16 at
    a small width: no KV cache, the SSM states threaded through the
    decode steps."""
    jc, tc = model_matches_jax("mamba2-130m", bf16_small)
    assert tc.kv is None and jc.kv is None and tc.ssm is not None


def test_mamba2_decode_continues_forward():
    decode_matches_own_forward("mamba2-130m")


def test_mamba2_serve_matches_jax_serve():
    serve_matches_jax("mamba2-130m")
