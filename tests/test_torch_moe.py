"""The moe family on the CPU: the port's ``models/moe.py`` (router,
dispatch, the MoE FFN) and the reduced grok-1 and llama4-maverick
``Model`` (forward, prefill caches, decode steps, the serve driver)
against the JAX package, on inputs made with numpy from a seed and
weights carried across with ``convert.params_from_jax``.

Tolerances: routing is exact (experts, slots and counts, drops
included); gates and the aux loss within 1e-6 (one f32 softmax against
another); the MoE FFN within 1e-5 (f32 sums in other orders); the models
as ``test_torch_models.py`` states them (``F32_TOL``, ``BF16_MODEL_REL``,
greedy tokens equal but at near-ties); in bf16 also routing equal but at
near-ties of the router (``ROUTE_TIE``), whose rows are left out.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from test_torch_models import (_logit_tol, _same_greedy, _tokens, configs,
                               f32, model_matches_jax, models,
                               serve_matches_jax)

MOE = ["grok-1-314b", "llama4-maverick-400b-a17b"]


def _router_inputs(t, d, e, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((d, e)) * d ** -0.5).astype(np.float32)
    return x, w


@pytest.mark.parametrize("t,d,e,k", [(37, 64, 8, 2), (50, 32, 128, 1),
                                     (16, 48, 4, 2)])
def test_router_matches_jax(t, d, e, k):
    x, w = _router_inputs(t, d, e, seed=t + e)
    jg, je, ja = jmoe.router(jnp.asarray(x), jnp.asarray(w), k)
    tg, te, ta = tmoe.router(torch.from_numpy(x), torch.from_numpy(w), k)
    assert te.dtype == torch.int32 and tg.dtype == torch.float32
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    assert abs(float(ta) - float(ja)) <= 1e-6


def test_router_ties_go_to_the_lower_expert():
    """Experts 1, 3 and 5 share one router column, so their probabilities
    tie exactly on every token: ``jax.lax.top_k`` ranks the lower expert
    first, and so does the port's stable sort."""
    x, w = _router_inputs(24, 32, 8, seed=3)
    w[:, 1] *= 3.0                     # the tied experts win on most rows
    w[:, 3] = w[:, 5] = w[:, 1]
    for k in (1, 2):
        _, je, _ = jmoe.router(jnp.asarray(x), jnp.asarray(w), k)
        _, te, _ = tmoe.router(torch.from_numpy(x), torch.from_numpy(w), k)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert np.any(np.asarray(je)[:, 0] == 1) and np.any(
        np.asarray(je)[:, 1] == 3)


@pytest.mark.parametrize("cf", [1.0, 0.5])
@pytest.mark.parametrize("k", [1, 2])
def test_dispatch_indices_match_jax_with_drops(cf, k):
    t, e = 40, 4
    rng = np.random.default_rng(7 + k)
    # skewed choices: expert 0 takes half the tokens, so some drop
    experts = np.where(rng.random((t, k)) < 0.5, 0,
                       rng.integers(0, e, (t, k))).astype(np.int32)
    cap = max(int(math.ceil(t * k / e * cf)), 1)
    js, jc = jmoe.dispatch_indices(jnp.asarray(experts), e, cap)
    ts, tc = tmoe.dispatch_indices(torch.from_numpy(experts), e, cap)
    assert ts.dtype == tc.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert np.any(ts.numpy() == -1)


def _ffn_inputs(t, d, e, ff, seed):
    rng = np.random.default_rng(seed)
    x, wr = _router_inputs(t, d, e, seed)
    w = [(rng.standard_normal(s) * s[1] ** -0.5).astype(np.float32)
         for s in ((e, d, ff), (e, d, ff), (e, ff, d))]
    return x, wr, *w


@pytest.mark.parametrize("t,e,k,cf", [(48, 4, 2, 1.25), (48, 4, 2, 8.0),
                                      (30, 16, 1, 1.25), (1, 8, 2, 1.25)])
def test_moe_ffn_matches_jax(t, e, k, cf):
    args = _ffn_inputs(t, 32, e, 48, seed=t * e)
    jy, ja = jmoe.moe_ffn(*map(jnp.asarray, args), topk=k,
                          capacity_factor=cf)
    ty, ta = tmoe.moe_ffn(*map(torch.from_numpy, args), topk=k,
                          capacity_factor=cf)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    assert abs(float(ta) - float(ja)) <= 1e-6


def test_moe_ffn_bf16_keeps_the_reference_rounding():
    args = _ffn_inputs(40, 32, 4, 48, seed=11)
    jy, _ = jmoe.moe_ffn(*(jnp.asarray(a, jnp.bfloat16) for a in args),
                         topk=2)
    ty, _ = tmoe.moe_ffn(*(torch.from_numpy(a).to(torch.bfloat16)
                           for a in args), topk=2)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(ty), f32(jy), rtol=2 ** -6, atol=2e-2)


@pytest.mark.parametrize("arch", MOE)
def test_moe_model_matches_jax(arch):
    model_matches_jax(arch, False)


def _routing_recorders(monkeypatch):
    """Record, per MoE call of each package on its own input, the token's
    experts in choice order and which of its choices kept a slot; and the
    port's smallest gap between consecutive router probabilities of the
    token's top k + 1 (two choices that swap order move the ranks, hence
    the drops, of the tokens after it)."""
    seen = {"jax": [], "port": []}

    def routing(mod, x, wr, e, k, cf):
        cap = max(int(math.ceil(x.shape[0] * k / e * cf)), 1)
        _, ex, _ = mod.router(x, wr, k)
        sl, _ = mod.dispatch_indices(ex, e, cap)
        return ex, sl

    def host(ex, sl):
        return np.asarray(ex), np.asarray(sl) >= 0

    def jrec(x, wr, wg, *w, topk, capacity_factor, **kw):
        # traced under jit and scan: the callback sees the values, in order
        jax.debug.callback(lambda ex, sl: seen["jax"].append(host(ex, sl)),
                           *routing(jmoe, x, wr, wg.shape[0], topk,
                                    capacity_factor), ordered=True)
        return jmoe_ffn(x, wr, wg, *w, topk=topk,
                        capacity_factor=capacity_factor, **kw)

    def trec(x, wr, wg, *w, topk, capacity_factor):
        ex, kept = host(*(a.numpy() for a in routing(
            tmoe, x, wr, wg.shape[0], topk, capacity_factor)))
        probs = torch.softmax(x.float() @ wr.float(), dim=-1)
        top = probs.sort(dim=-1, descending=True).values[:, :topk + 1]
        seen["port"].append((ex, kept, (top[:, :-1] - top[:, 1:]).amin(
            dim=-1).numpy()))
        return tmoe.moe_ffn(x, wr, wg, *w, topk=topk,
                            capacity_factor=capacity_factor)
    jmoe_ffn = jmoe.moe_ffn
    monkeypatch.setattr(jmoe, "moe_ffn", jrec)
    monkeypatch.setattr(tmodel, "moe_ffn", trec)
    return seen


def _rerouted(seen, shape, prior) -> np.ndarray:
    """Which (B, L) tokens of the last recorded calls (one per MoE layer,
    in order) the two packages routed apart (other experts, another order
    of them, or another choice dropped) or that carry such a token's
    change: a rerouted token taints its own and its sequence's later
    positions in the layers after it (causal attention), and ``prior``
    (B,) taints whole sequences. An untainted token taking other experts
    must sit at a near-tie (``ROUTE_TIE``); a drop that differs alone needs
    a token routed apart in its call (ranks are choice-major: any token's
    first choice ranks before every second choice, so a later token can
    move an earlier one's drop)."""
    tainted = np.broadcast_to(prior[:, None], shape).copy()
    for (jex, jkept), (tex, tkept, gap) in zip(seen["jax"], seen["port"]):
        other = np.any(jex != tex, axis=-1).reshape(shape)
        dropped = np.any(jkept != tkept, axis=-1).reshape(shape) & ~other
        fresh = other & ~tainted
        assert np.all(gap.reshape(shape)[fresh] < ROUTE_TIE)
        assert other.any() or not dropped.any()
        tainted |= np.cumsum(other | dropped, axis=1) > 0
    seen["jax"].clear()
    seen["port"].clear()
    return tainted


# XLA and PyTorch round a few bf16 projection outputs apart
# (test_torch_models.py), which moves the router's f32 probabilities by up
# to 1.7e-3 after one layer and 3.1e-3 after two (measured here); a token
# two of whose top k + 1 experts are that close may route either way
ROUTE_TIE = 1e-2


def test_moe_model_bf16_matches_jax(monkeypatch):
    """grok-1's expert geometry (E=8, top-2, capacity 1.25) in bf16 at a
    small width, against JAX, each MoE call's routing recorded in both
    packages (JAX's by a callback from the jitted step). Routing is
    equal except at near-ties (``ROUTE_TIE``), where a token may take
    another expert and move its logits wholesale: such a token's later
    positions (causal attention carries it forward) and, in decode, its
    sequence from then on are reported and left out; every other row's
    logits within ``BF16_MODEL_REL`` and its greedy token equal."""
    jcfg, tcfg = configs("grok-1-314b", True)
    assert tcfg.capacity_factor == 1.25 and tcfg.moe_topk == 2
    jm, params, tm = models(jcfg, tcfg)
    seen = _routing_recorders(monkeypatch)
    toks = _tokens(jcfg.vocab, 3, 16, seed=2)
    jl, jc, _ = jm.forward(params, jnp.asarray(toks), collect_cache=True,
                           cache_size=26)
    with torch.inference_mode():
        tl, tc = tm(torch.from_numpy(toks).long(), collect_cache=True,
                    cache_size=26)
    jax.effects_barrier()
    keep = ~_rerouted(seen, toks.shape, np.zeros(len(toks), bool))
    live = keep.all(axis=1)                           # sequences
    jl, tl = f32(jl), f32(tl)
    np.testing.assert_allclose(tl[keep], jl[keep], **_logit_tol(jcfg, jl))
    _same_greedy(jl[keep], tl[keep], "bf16 grok forward",
                 2 * np.abs(tl[keep] - jl[keep]).max())
    nt = jl[:, -1:].argmax(-1)
    decode = jax.jit(jm.decode_step)
    for step in range(4):
        jd, jc = decode(params, jc, jnp.asarray(nt))
        jax.effects_barrier()
        with torch.inference_mode():
            td, tc = tm.decode_step(tc, torch.from_numpy(nt).long())
        live &= ~_rerouted(seen, (len(live), 1), ~live)[:, 0]
        jd, td = f32(jd), f32(td)
        np.testing.assert_allclose(td[live], jd[live], **_logit_tol(jcfg, jd))
        _same_greedy(jd[live], td[live], f"bf16 grok decode step {step}",
                     2 * np.abs(td[live] - jd[live]).max())
        nt = jd.argmax(-1)
    print(f"bf16 grok: {int((~keep).sum())} of {keep.size} prefill rows and "
          f"{int((~live).sum())} of {live.size} sequences after a routing "
          "near-tie, left out")
    assert live.any() and keep.mean() >= 0.5


def test_moe_model_with_drops_matches_jax(monkeypatch):
    """The reduced configs set ``capacity_factor=8.0`` (nothing drops);
    at the published 1.25 tokens drop. Logits and greedy tokens against
    JAX, and each MoE call's routing exactly equal to JAX's on the same
    input, drops included."""
    jcfg, tcfg = (dataclasses.replace(c, capacity_factor=1.25)
                  for c in configs("grok-1-314b"))
    seen = []

    def recording(x, *w, topk, capacity_factor):
        seen.append((x.clone(), [a.clone() for a in w], topk,
                     capacity_factor))
        return tmoe.moe_ffn(x, *w, topk=topk,
                            capacity_factor=capacity_factor)
    monkeypatch.setattr(tmodel, "moe_ffn", recording)
    model_matches_jax(None, False, cfgs=(jcfg, tcfg), steps=4)
    drops = 0
    for x, (wr, wg, wu, wd), k, cf in seen:
        t, e = x.shape[0], wg.shape[0]
        cap = max(int(math.ceil(t * k / e * cf)), 1)
        _, je, _ = jmoe.router(jnp.asarray(x.numpy()), jnp.asarray(wr.numpy()),
                               k)
        js, jc = jmoe.dispatch_indices(je, e, cap)
        _, te, _ = tmoe.router(x, wr, k)
        ts, tc = tmoe.dispatch_indices(te, e, cap)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        drops += int((ts.numpy() < 0).sum())
    assert len(seen) == 2 * 5 and drops > 0   # 2 layers: prefill, 4 steps


def test_moe_serve_matches_jax_serve():
    serve_matches_jax("grok-1-314b")
