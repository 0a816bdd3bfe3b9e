"""Training on the CPU against the JAX package: ``Model.loss_fn`` and every
parameter's gradient for all ten reduced configs (MoE auxiliary loss
included), rematerialization, the flash-attention backward's plain
version and the autograd wiring that carries it, AdamW, and the training
driver step by step.

Inputs are drawn with numpy from a seed and the weights carried across
with ``convert.params_from_jax``. Tolerances, with their reasons:
  * loss: 1e-5 relative. Both packages sum the same f32 terms in other
    orders (measured: under 1e-6 on losses of ~7.5).
  * gradients: 1e-4 of each leaf's largest |gradient|. The backward sums
    every layer's products in another order (measured: at most 1.5e-5 of
    the largest, hymba's ``mlp_down``).
  * remat: the same numbers, to 1e-6 of each leaf's largest |gradient|;
    recomputing a layer group must not change them.
  * the flash backward: 1e-5 absolute on unit-scale inputs, against
    ``jax.vjp`` of the JAX oracle (f32 einsums both sides).
  * AdamW: parameters and moments within 1e-6 relative, the learning rate
    exactly and the gradient norm within 1e-6 relative.
  * ``launch.train``: losses within 1e-5 and gradient norms within 1e-4
    relative over four steps (the same batches, the same f32 updates).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES, get_arch as jget_arch
from repro.data.qa_dataset import build_corpus as jbuild_corpus
from repro.data.tokenizer import HashTokenizer as JTokenizer
from repro.kernels import ref as jref
from repro.launch.train import make_batches as jmake_batches
from repro.models import attention as jattn
from repro.models.model import Model as JModel
from repro.training import optimizer as jopt
from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.data.qa_dataset import build_corpus
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.training import optimizer as topt

LOSS_RTOL = 1e-5
GRAD_SHARE = 1e-4
REMAT_SHARE = 1e-6


def _models(arch, remat_policy="full", seed=0):
    jcfg, tcfg = jget_arch(arch).reduced(), get_arch(arch).reduced()
    jm = JModel(jcfg)
    params = jax.jit(jm.init_params)(jax.random.PRNGKey(seed))
    tm = Model(tcfg, device="cpu", remat_policy=remat_policy)
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


def _batch(cfg, b=2, l=24, seed=7):
    """Tokens ((B, L), or (B, L, C) for audio) and the frontend's prefix
    embeddings where the config takes them."""
    rng = np.random.default_rng(seed)
    books = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    toks = rng.integers(0, cfg.vocab, (b, l) + books).astype(np.int32)
    pre = rng.standard_normal((b, cfg.n_prefix, cfg.d_model)).astype(
        np.float32) if cfg.n_prefix else None
    return toks, pre


def _port_loss_and_grads(tm, toks, pre, **kw):
    tm.requires_grad_(True)
    tm.zero_grad(set_to_none=True)
    loss = tm.loss_fn(torch.from_numpy(toks).long(),
                      prefix_emb=None if pre is None
                      else torch.from_numpy(pre), **kw)
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone()
                                  for n, p in tm.named_parameters()}


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_loss_and_every_gradient_match_jax(arch):
    """``loss_fn`` (remat "full", MoE aux weighted 0.01) and the gradient
    of every parameter against ``jax.value_and_grad`` of the JAX
    ``loss_fn``; the MoE configs' aux is not zero, so it is in both."""
    jm, params, tm = _models(arch)
    toks, pre = _batch(jm.config)
    jpre = None if pre is None else jnp.asarray(pre)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, t, e: jm.loss_fn(p, t, prefix_emb=e)))(
        params, jnp.asarray(toks), jpre)
    loss, grads = _port_loss_and_grads(tm, toks, pre)
    assert abs(loss - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(want) == set(grads)
    for name, w in want.items():
        err = float((grads[name] - w).abs().max())
        assert err <= GRAD_SHARE * max(float(w.abs().max()), 1e-12), name
    _, jaux = jm.forward(params, jnp.asarray(toks), prefix_emb=jpre)
    with torch.no_grad():
        _, aux = tm(torch.from_numpy(toks).long(), return_aux=True,
                    prefix_emb=None if pre is None else torch.from_numpy(pre))
    assert abs(float(aux) - float(jaux)) <= 1e-5 * max(abs(float(jaux)), 1)
    assert (float(aux) > 0) == jm.config.is_moe


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ["yi-6b", "grok-1-314b", "hymba-1.5b",
                                  "musicgen-large"])
def test_remat_changes_no_number(arch, policy):
    """Rematerializing each layer group ("full", or keeping the matmul
    outputs: "dots") gives the loss and gradients of no remat."""
    _, _, none = _models(arch, "none")
    _, _, tm = _models(arch, policy)
    toks, pre = _batch(tm.config, seed=11)
    loss0, grads0 = _port_loss_and_grads(none, toks, pre)
    loss1, grads1 = _port_loss_and_grads(tm, toks, pre)
    assert loss1 == pytest.approx(loss0, rel=1e-7)
    for name, g in grads0.items():
        err = float((grads1[name] - g).abs().max())
        assert err <= REMAT_SHARE * max(float(g.abs().max()), 1e-12), name


def test_remat_policy_is_checked_and_remat_needs_grad():
    cfg = get_arch("yi-6b").reduced()
    with pytest.raises(ValueError, match="remat_policy"):
        Model(cfg, device="cpu", remat_policy="some")
    m = Model(cfg, device="cpu").init_params(prng.key(0))
    toks = torch.from_numpy(_batch(cfg)[0]).long()
    with torch.no_grad():   # no graph: remat is a no-op
        a = m(toks, remat=True)
    b = m(toks)
    assert torch.equal(a, b)


# --------------------------------------------------------------------- #
# the flash-attention backward (plain version) and its autograd wiring
# --------------------------------------------------------------------- #
BWD_CASES = [  # (B, Lq, Lk, H, HKV, D, causal, window, n_sink)
    (2, 40, 40, 4, 4, 64, True, None, 0),     # G=1
    (2, 40, 40, 4, 2, 64, True, None, 0),     # G=2
    (1, 70, 70, 4, 2, 64, True, 16, 0),       # window, G=2
    (1, 30, 50, 2, 1, 64, True, None, 0),     # Lk > Lq
    (1, 48, 48, 4, 2, 64, False, None, 0),    # not causal
    (1, 70, 70, 4, 2, 64, True, 16, 5),       # window with sinks
    (1, 40, 80, 4, 1, 64, True, 20, 12),      # Lk > Lq with sinks, G=4
]


def _bwd_inputs(b, lq, lk, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) * sc for s, sc in (
        ((b, lq, h, d), 0.5), ((b, lk, hkv, d), 0.5), ((b, lk, hkv, d), 1.0),
        ((b, lq, h, d), 1.0))]


@pytest.mark.parametrize("b,lq,lk,h,hkv,d,causal,window,n_sink", BWD_CASES)
def test_flash_backward_plain_version_matches_jax(b, lq, lk, h, hkv, d,
                                                  causal, window, n_sink):
    """``ref.flash_attention_bwd_ref`` (from the forward's log-sum-exp)
    against ``jax.vjp`` of the JAX oracle ``kernels/ref.py::
    flash_attention_ref`` with K/V expanded to H heads (the expanded
    gradients summed over each group), or, with sinks, which that oracle
    lacks, of the JAX ``blockwise_attention``; and against autograd of the
    port's own plain forward."""
    q, k, v, g = _bwd_inputs(b, lq, lk, h, hkv, d, seed=lq + lk + n_sink)
    rep = h // hkv
    kw = dict(causal=causal, window=window, n_sink=n_sink)
    if n_sink:
        jout, vjp = jax.vjp(lambda q, k, v: jattn.blockwise_attention(
            q, k, v, block_q=16, block_k=16, **kw), q, k, v)
        jdq, jdk, jdv = vjp(jnp.asarray(g))
    else:
        jout, vjp = jax.vjp(lambda q, k, v: jref.flash_attention_ref(
            q, jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2),
            causal=causal, window=window), q, k, v)
        jdq, jdk, jdv = vjp(jnp.asarray(g))
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = tref.flash_attention_lse_ref(tq, tk, tv, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)
    got = tref.flash_attention_bwd_ref(tq, tk, tv, out, tg, lse, **kw)
    for x, w in zip(got, (jdq, jdk, jdv)):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    auto = torch.autograd.grad(tref.flash_attention_ref(*leaves, **kw),
                               leaves, tg)
    for x, w in zip(got, auto):
        torch.testing.assert_close(x, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("b,lq,lk,h,hkv,d,splits,scratch", [
    (8, 128, 128, 12, 2, 128, 5, 10_485_760),   # qwen2-vl-2b's training step
    (4, 192, 192, 32, 32, 64, 1, 0),            # musicgen-large's: 384 blocks
    (2, 192, 192, 25, 5, 64, 5, 4_915_200),     # hymba-1.5b's geometry
    (1, 64, 64, 4, 4, 64, 1, 0),                # one tile, one item a tile
])
def test_bwd_plan_fills_the_card_with_the_fewest_slices(b, lq, lk, h, hkv, d,
                                                        splits, scratch):
    """``bwd_plan`` on an H100's 132 SMs: at least one slice; at least one
    dK/dV block an SM wherever a key tile's items allow, with the fewest
    slices that give it (one where the grid already fills the card); dQ one
    block a query tile and head; the f32 partials' bytes the wrapper
    allocates, (2, S, B, Lk, HKV, D), none with one slice."""
    n_sm = 132
    plan = kflash.bwd_plan(b, lq, lk, h, hkv, d, n_sm)
    tiles = -(-lk // 64) * hkv * b
    items = (h // hkv) * -(-lq // 64)
    assert (plan.splits, plan.scratch_bytes) == (splits, scratch)
    assert plan.splits >= 1 and plan.dkdv_blocks == tiles * plan.splits
    assert plan.dkdv_blocks >= n_sm or plan.splits == items
    assert plan.splits == 1 or (plan.splits - 1) * tiles < n_sm
    assert plan.dq_blocks == -(-lq // 64) * h * b
    assert plan.scratch_bytes == (0 if plan.splits == 1 else
                                  2 * plan.splits * b * lk * hkv * d * 4)


def test_lse_of_rows_that_see_nothing_and_their_zero_gradient():
    """A causal query row before the first key (Lk < Lq) sees nothing: its
    log-sum-exp is -inf, its output 0 and its dq 0; no NaN reaches dk or
    dv."""
    q, k, v, g = map(torch.from_numpy, _bwd_inputs(1, 30, 20, 2, 1, 64, 3))
    out, lse = tref.flash_attention_lse_ref(q, k, v)
    assert bool(torch.isinf(lse[..., :10]).all())
    assert bool(torch.isfinite(lse[..., 10:]).all())
    dq, dk, dv = tref.flash_attention_bwd_ref(q, k, v, out, g, lse)
    assert float(out[:, :10].abs().max()) == 0.0
    assert float(dq[:, :10].abs().max()) == 0.0
    assert all(bool(torch.isfinite(t).all()) for t in (dq, dk, dv))


def test_ops_flash_attention_routes_training_through_the_function():
    """With operands that require grad, ``ops.flash_attention`` runs the
    autograd Function (plain forward and backward on the CPU, the same
    wiring as the card's kernels): the output has its grad_fn and the
    forward's numbers; without grad it is the plain version with no
    history. ``flash_attention_cuda`` refuses training operands rather
    than return an output without gradient, and decode attention raises
    under grad on either route."""
    q, k, v, g = map(torch.from_numpy, _bwd_inputs(2, 20, 20, 4, 2, 64, 5))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, window=8, n_sink=2)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    plain = ops.flash_attention(q, k, v, window=8, n_sink=2)
    assert plain.grad_fn is None and torch.equal(out.detach(), plain)
    with torch.no_grad():
        assert ops.flash_attention(*leaves).grad_fn is None
    with pytest.raises(RuntimeError, match="autograd"):
        kflash.flash_attention_cuda(*leaves)
    slot_pos = torch.arange(20, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.decode_attention(leaves[0][:, :1], leaves[1], leaves[2],
                             slot_pos, 19)
    assert kflash.launches.keys() == {"flash_attention",
                                      "flash_attention_bwd"}


def test_model_gradient_reaches_the_attention_projections():
    """Through the model, the loss's gradient reaches ``wq``/``wk``/``wv``
    (the attention output carries its history), and ``decode_step``
    refuses to run while parameters require grad."""
    cfg = get_arch("yi-6b").reduced()
    m = Model(cfg, device="cpu").init_params(prng.key(0))
    m.requires_grad_(True)
    toks = torch.from_numpy(_batch(cfg)[0]).long()
    m.loss_fn(toks).backward()
    for name in ("wq", "wk", "wv", "wo"):
        assert float(m.blocks[name].grad.abs().max()) > 0, name
    caches = m.init_decode_caches(2, 8)
    with pytest.raises(RuntimeError, match="inference only"):
        m.decode_step(caches, toks[:, :1])
    with torch.no_grad():
        logits, _ = m.decode_step(caches, toks[:, :1])
    assert logits.shape == (2, 1, cfg.padded_vocab)


# --------------------------------------------------------------------- #
# AdamW and the training driver
# --------------------------------------------------------------------- #
def test_adamw_update_matches_jax_over_three_steps():
    """Three ``adamw_update`` steps on a tree of a matrix (decayed), a
    stacked (2, 3, 4) weight (decayed), a bf16 matrix (cast back) and a
    norm vector (not decayed), with gradients large enough to clip:
    parameters, moments, learning rate and gradient norm as JAX's."""
    rng = np.random.default_rng(0)
    shapes = {"w": (5, 3), "stack": (2, 3, 4), "half": (4, 4), "norm": (6,)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=1.0)
    jcfg, tcfg = jopt.AdamWConfig(**cfg), topt.AdamWConfig(**cfg)
    jp = {n: jnp.asarray(a, jnp.bfloat16 if n == "half" else jnp.float32)
          for n, a in params.items()}
    tp = {n: torch.from_numpy(a).to(torch.bfloat16 if n == "half"
                                    else torch.float32)
          for n, a in params.items()}
    js, ts = jopt.init_adamw(jp), topt.init_adamw(tp)
    for step in range(3):
        grads = {n: rng.standard_normal(s).astype(np.float32) * 3
                 for n, s in shapes.items()}
        jp, js, jm = jopt.adamw_update(
            jcfg, jp, {n: jnp.asarray(g, jp[n].dtype)
                       for n, g in grads.items()}, js)
        tp, ts, tm = topt.adamw_update(
            tcfg, tp, {n: torch.from_numpy(g).to(tp[n].dtype)
                       for n, g in grads.items()}, ts)
        assert ts.step == int(js.step) == step + 1
        assert tm["lr"] == float(jm["lr"])
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        for n in shapes:
            assert tp[n].dtype == (torch.bfloat16 if n == "half"
                                   else torch.float32)
            for mine, theirs in ((tp[n], jp[n]), (ts.m[n], js.m[n]),
                                 (ts.v[n], js.v[n])):
                np.testing.assert_allclose(
                    mine.to(torch.float32).numpy(),
                    np.asarray(theirs, np.float32), rtol=1e-6, atol=1e-7)


def test_lr_schedule_and_global_norm_match_jax():
    cfg = dict(lr=3e-3, warmup_steps=5, total_steps=40, min_lr_ratio=0.1)
    for step in (0, 1, 4, 5, 6, 20, 39, 40, 55):
        assert topt.lr_at(topt.AdamWConfig(**cfg), step) == float(
            jopt.lr_at(jopt.AdamWConfig(**cfg), jnp.asarray(step, jnp.int32)))
    rng = np.random.default_rng(1)
    leaves = [rng.standard_normal(s).astype(np.float32)
              for s in ((3, 4), (7,), (2, 2, 2))]
    assert float(topt.global_norm(map(torch.from_numpy, leaves))) == \
        pytest.approx(float(jopt.global_norm(leaves)), rel=1e-7)


def test_inplace_update_and_train_step_keep_the_tensors():
    """``make_train_step`` updates the model's own parameters in place (the
    dict it returns holds the same tensors) with ``adamw_update``'s
    numbers on the loss's gradients."""
    cfg = get_arch("yi-6b").reduced()
    m = Model(cfg, device="cpu").init_params(prng.key(0))
    m.requires_grad_(True)
    named = dict(m.named_parameters())
    before = {n: p.detach().clone() for n, p in named.items()}
    ocfg = topt.AdamWConfig(lr=1e-3)
    toks = torch.from_numpy(_batch(cfg)[0]).long()
    step = topt.make_train_step(lambda _p, t: m.loss_fn(t), ocfg)
    out, state, metrics = step(named, topt.init_adamw(named), toks)
    assert all(out[n] is named[n] for n in named) and state.step == 1
    ref = Model(cfg, device="cpu")
    ref.load_state_dict(before)
    ref.requires_grad_(True)
    loss = ref.loss_fn(toks)
    grads = dict(zip(before, torch.autograd.grad(loss, list(
        ref.parameters()))))
    want, _, _ = topt.adamw_update(ocfg, dict(ref.named_parameters()), grads,
                                   topt.init_adamw(before))
    assert float(metrics["loss"]) == float(loss.detach())
    for n, p in named.items():
        torch.testing.assert_close(p.detach(), want[n], rtol=0, atol=0)


def test_make_batches_equal_the_reference_rows():
    cfg = get_arch("deepseek-7b").reduced()
    mine = ttrain.make_batches(HashTokenizer(vocab_size=cfg.vocab),
                               build_corpus(500), 4, 32, cfg.vocab)
    theirs = jmake_batches(JTokenizer(vocab_size=cfg.vocab),
                           jbuild_corpus(500), 4, 32, cfg.vocab)
    for _ in range(3):
        assert np.array_equal(next(mine), np.asarray(next(theirs)))


def test_train_driver_matches_the_jax_step_loop(tmp_path, capsys):
    """``launch.train`` on the reduced deepseek-7b from the JAX package's
    initial weights against ``repro.launch.train``'s jitted step loop:
    four steps (loss, learning rate, gradient norm); its log lines are the
    reference's and its checkpoint holds every parameter under the
    reference's keys."""
    jcfg = jget_arch("deepseek-7b").reduced()
    jm = JModel(jcfg)
    params = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    steps, batch, seq = 4, 2, 32
    ckpt = str(tmp_path / "ck")
    out = ttrain.train("deepseek-7b", steps=steps, batch=batch, seq=seq,
                       device="cpu", checkpoint=ckpt, log_every=2,
                       params=params_from_jax(jax.tree_util.tree_map(
                           np.asarray, params)))
    ocfg = jopt.AdamWConfig(lr=3e-3, warmup_steps=max(steps // 20, 1),
                            total_steps=steps)
    opt = jopt.init_adamw(params)

    @jax.jit
    def step(params, opt, tokens):
        loss, grads = jax.value_and_grad(
            lambda p: jm.loss_fn(p, tokens, remat=True))(params)
        params, opt, metrics = jopt.adamw_update(ocfg, params, grads, opt)
        return params, opt, loss, metrics

    batches = jmake_batches(JTokenizer(vocab_size=jcfg.vocab),
                            jbuild_corpus(500), batch, seq, jcfg.vocab)
    for i in range(steps):
        params, opt, loss, metrics = step(params, opt, next(batches))
        assert out["loss"][i] == pytest.approx(float(loss), rel=1e-5)
        assert out["lr"][i] == float(metrics["lr"])
        assert out["grad_norm"][i] == pytest.approx(
            float(metrics["grad_norm"]), rel=1e-4)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("arch=deepseek-7b-smoke params=")
    assert [ln.split()[1] for ln in lines[1:4]] == ["0", "2", "3"]
    assert lines[-1] == f"checkpoint -> {ckpt}"
    from repro_torch.training.checkpoint import open_checkpoint
    saved = open_checkpoint(ckpt)
    assert set(saved) == {f"params/{n.replace('.', '/')}"
                          for n, _ in out["model"].named_parameters()}


def test_train_driver_refuses_audio_as_the_reference_fails():
    """Both training drivers feed (B, L) text tokens: the JAX ``loss_fn``
    of reduced musicgen fails on them, and ``launch.train`` raises a
    ValueError naming the reason before it builds anything."""
    jcfg = jget_arch("musicgen-large").reduced()
    jm = JModel(jcfg)
    params = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    toks = jnp.asarray(_batch(get_arch("yi-6b").reduced())[0])
    with pytest.raises(Exception):
        jm.loss_fn(params, toks)
    with pytest.raises(ValueError, match="codebook"):
        ttrain.train("musicgen-large", steps=1, device="cpu")


def test_train_cli_runs_on_cpu(capsys):
    ttrain.main(["--arch", "mamba2-130m", "--steps", "2", "--batch", "2",
                 "--seq", "16", "--device", "cpu", "--log-every", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and lines[2].startswith("step     1 loss ")


def test_adamw_chunks_give_the_same_numbers_in_place(monkeypatch):
    """A leaf updated a few elements at a time (``CHUNK``) gets the bits of
    the whole-leaf update, and the update writes into the given parameter
    and moment tensors."""
    gen = torch.Generator().manual_seed(3)
    params = {"w": torch.randn((100, 37), generator=gen),
              "h": torch.randn((50,), generator=gen).to(torch.bfloat16)}
    grads = {n: torch.randn(t.shape, generator=gen).to(t.dtype)
             for n, t in params.items()}
    cfg = topt.AdamWConfig(lr=1e-2, warmup_steps=1)
    runs = []
    for chunk in (topt.CHUNK, 7):
        monkeypatch.setattr(topt, "CHUNK", chunk)
        mine = {n: t.clone() for n, t in params.items()}
        state = topt.init_adamw(mine)
        out, new_state, _ = topt.adamw_update(cfg, mine, grads, state)
        assert new_state.step == 1
        for n in mine:
            assert out[n] is mine[n] and new_state.m[n] is state.m[n]
            assert not torch.equal(mine[n], params[n])
        runs.append((out, new_state))
    (whole, ws), (parts, ps) = runs
    for n in params:
        assert torch.equal(parts[n], whole[n])
        assert torch.equal(ps.m[n], ws.m[n]) and torch.equal(ps.v[n], ws.v[n])
