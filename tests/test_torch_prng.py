"""``repro_torch.prng`` against ``jax.random`` on the CPU, and the port's
own seeded draws against the reference's: model weights for every config,
the MiniLM encoder, the training driver and the model-backed serve driver,
each from key 0 with nothing carried across (the IVF index and engine are
held in ``test_torch_ivf.py``).

Tolerances, with their reasons:
  * keys, splits, fold-ins, bits and uniforms: bit for bit (integer work
    and one exact float step).
  * normals: ``NORMAL_REL`` (1e-5) relative. Both sides take
    sqrt(2) * erfinv(u) with XLA's polynomial, but the CPU's log1p inside
    it rounds apart from XLA's now and then (measured: 2.4e-7 at most,
    98.7% of draws bit-equal).
  * f32 weights: ``NORMAL_REL``, the normals' own tolerance times an exact
    f32 scale product. bf16 weights: equal, except where the f32 value
    sits at a bf16 rounding boundary (within ``NORMAL_REL`` of the
    midpoint of the two neighbours); those are counted and must lie 1 ulp
    apart.
  * training losses: ``LOSS_TOL`` (1e-4) absolute, the step loop's sums
    in another order on weights within ``NORMAL_REL``.

JAX runs threefry in partitionable mode here (the fixture), the only mode
the port has: it is the default from jax 0.5 on.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from repro.configs import get_arch as jget_arch
from repro.data.qa_dataset import build_corpus as jbuild_corpus
from repro.data.tokenizer import HashTokenizer as JTokenizer
from repro.embedding import encoder as jenc
from repro.launch.train import make_batches as jmake_batches
from repro.models.model import Model as JModel
from repro.training import optimizer as jopt
from repro_torch import prng
from repro_torch.configs import ARCHITECTURES, get_arch
from repro_torch.embedding import MINILM_L6, EncoderConfig
from repro_torch.embedding import init_encoder_params
from repro_torch.kernels import ops, ref
from repro_torch.kernels import threefry as kthreefry
from repro_torch.launch import serve
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from test_torch_models import SMALL_BF16, jax_serve

NORMAL_REL = 1e-5
LOSS_TOL = 1e-4
SEEDS = (0, 1, 17, 42, 2 ** 31 + 5, 2 ** 32 - 1)
NARROW = EncoderConfig(vocab=512, d_model=64, n_layers=2, n_heads=4,
                       d_ff=128, max_len=32)


@pytest.fixture(autouse=True)
def threefry_partitionable():
    """The port's mode, also under jax < 0.5, where it is off by default."""
    was = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", was)


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint32)


# --------------------------------------------------------------------- #
# the streams
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_equal_jax(seed):
    k, jk = prng.key(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(k, _u32(jk))
    for num in (1, 2, 3, 16):
        np.testing.assert_array_equal(prng.split(k, num),
                                      _u32(jax.random.split(jk, num)))
    for data in (0, 1, 7, 2 ** 31, 2 ** 32 - 1):
        np.testing.assert_array_equal(prng.fold_in(k, data),
                                      _u32(jax.random.fold_in(jk, data)))
    # fold-like splitting: fold_in(k, i) is key i of a split
    np.testing.assert_array_equal(prng.fold_in(k, 5), prng.split(k, 8)[5])
    with pytest.raises(ValueError, match="uint32"):
        prng.fold_in(k, 2 ** 32)


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shape", [(1,), (7, 5), (3, 64, 33)])
def test_bits_and_uniforms_equal_jax_bit_for_bit(seed, shape):
    k, jk = prng.key(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        prng.bits(k, shape, device="cpu").numpy(),
        np.asarray(jax.random.bits(jk, shape)).astype(np.int64))
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    for minval, maxval in ((0.0, 1.0), (lo, 1.0), (-2.5, 3.0)):
        got = prng.uniform(k, shape, minval=minval, maxval=maxval,
                           device="cpu")
        want = np.asarray(jax.random.uniform(jk, shape, jnp.float32,
                                             minval, maxval))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_bits_past_two_to_the_32_equal_jax_threefry_on_explicit_counts():
    """A flat counter past 2^32 takes the high word, as JAX's
    ``iota_2x32_shape`` splits it (grok-1's whole-depth MoE stacks pass
    2^32 elements); held against ``threefry2x32`` on the explicit words."""
    k = prng.key(7)
    for off in (2 ** 32 - 500, 2 ** 32 + 12345, 3 * 2 ** 32 + 1):
        c = np.arange(off, off + 1000, dtype=np.uint64)
        b0, b1 = jprng.threefry2x32_p.bind(
            jnp.uint32(k[0]), jnp.uint32(k[1]),
            jnp.asarray((c >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((c & np.uint64(0xFFFFFFFF)).astype(np.uint32)))
        np.testing.assert_array_equal(
            prng.bits(k, (1000,), offset=off, device="cpu").numpy(),
            np.asarray(b0 ^ b1).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_normals_within_1e5_relative_of_jax(seed):
    """The largest relative difference found over 2^18 draws a seed is
    2.4e-7 (seed 17), with 98.7% of the draws bit-equal."""
    shape = (256, 1024)
    got = prng.normal(prng.key(seed), shape, device="cpu").numpy()
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    rel = np.abs(got - want) / np.abs(want)
    assert rel.max() < NORMAL_REL, rel.max()
    assert (got == want).mean() > 0.98
    # a scale and a cast round once, after the f32 product, as JAX's
    # ``(normal * scale).astype(dtype)`` does
    scaled = prng.normal(prng.key(seed), shape, scale=0.02,
                         dtype=torch.bfloat16, device="cpu")
    assert torch.equal(scaled, torch.from_numpy(got * np.float32(0.02)).to(
        torch.bfloat16))


@pytest.mark.parametrize("kind", ["bits", "uniform", "normal", "bf16"])
def test_a_draw_at_an_offset_is_that_slice_of_the_whole_draw(kind):
    k, shape = prng.key(3), (40, 96)
    draw = {"bits": lambda **kw: prng.bits(k, device="cpu", **kw),
            "uniform": lambda **kw: prng.uniform(k, device="cpu", **kw),
            "normal": lambda **kw: prng.normal(k, device="cpu", **kw),
            "bf16": lambda **kw: prng.normal(k, device="cpu", scale=0.5,
                                             dtype=torch.bfloat16, **kw)}[kind]
    whole = draw(shape=shape).reshape(-1)
    for off, n in ((0, 1), (96, 7 * 96), (1001, 2839)):
        assert torch.equal(draw(shape=(n,), offset=off), whole[off:off + n])
    # chunks of the plain version end where they end: the same numbers
    assert ref.THREEFRY_CHUNK < 2 ** 21
    big = draw(shape=(ref.THREEFRY_CHUNK + 5,), offset=11)
    assert torch.equal(big[-6:], draw(shape=(6,),
                                      offset=10 + ref.THREEFRY_CHUNK))


def test_choice_gives_jax_rows_over_twenty_seeds():
    """``jax.random.choice(replace=True, p=)``'s rows at N=16,384, c=128,
    as ``IVFIndex.refit`` weighs them (alive + 1e-6, normalized), for
    slabs from all to almost none alive: with 16 of 16,384 alive a draw
    in a thousand lands among the dead rows, where only the running sum's
    rounding picks the row."""
    n, c = 16384, 128
    for seed in range(20):
        rng = np.random.default_rng(seed)
        alive = rng.random(n) < (0.9, 0.5, 0.05, 1.0, 0.001)[seed % 5]
        jp = jnp.asarray(alive).astype(jnp.float32) + 1e-6
        want = np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n,
                                            shape=(c,), replace=True,
                                            p=jp / jp.sum()))
        p = torch.from_numpy(alive).float() + 1e-6
        got = prng.choice(prng.key(seed), n, (c,), p / prng.xla_sum(p))
        assert got.dtype == torch.int64 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [5, 16, 33, 300, 16384, 65536, 100000])
def test_sums_add_in_xla_order(n):
    """``xla_sum`` and ``xla_cumsum`` equal ``jnp.sum`` and ``jnp.cumsum``
    on the CPU bit for bit, on choice-like weights and on signed ones.
    They copy the order of XLA:CPU's rewrites in the jax these tests run
    (ROADMAP "Kept on purpose": `choice` sums); after a jax upgrade a
    failure here means that order moved, not that the draw did."""
    rng = np.random.default_rng(n)
    for x in ((rng.random(n) < 0.3).astype(np.float32) + np.float32(1e-6),
              rng.standard_normal(n).astype(np.float32)):
        t = torch.from_numpy(x)
        assert float(prng.xla_sum(t)) == float(jnp.sum(jnp.asarray(x)))
        np.testing.assert_array_equal(prng.xla_cumsum(t).numpy(),
                                      np.asarray(jnp.cumsum(jnp.asarray(x))))


def test_fill_checks_its_arguments_and_routes_by_device():
    out = torch.empty(4, dtype=torch.float32)
    with pytest.raises(ValueError, match="kind"):
        ops.threefry_fill(out, (0, 1), kind="gumbel")
    with pytest.raises(ValueError, match="fills"):
        ops.threefry_fill(out, (0, 1), kind="bits")
    with pytest.raises(ValueError, match="fills"):
        ops.threefry_fill(torch.empty(4, dtype=torch.float16), (0, 1))
    with pytest.raises(ValueError, match="contiguous"):
        ops.threefry_fill(torch.empty(4, 2).t(), (0, 1))
    with pytest.raises(ValueError, match="two uint32"):
        ops.threefry_fill(out, (0, 2 ** 32))
    with pytest.raises(ValueError, match="64 bits"):
        ops.threefry_fill(out, (0, 1), offset=2 ** 64 - 2)
    with pytest.raises(ValueError, match="key"):
        prng.normal(np.array([0, 1], dtype=np.int64), (2,), device="cpu")
    # the wrapper launches or raises; CPU tensors go through ops only
    with pytest.raises(RuntimeError, match="takes CUDA tensors"):
        kthreefry.threefry_cuda(out, (0, 1))
    # meta tensors keep their shape and draw nothing
    meta = prng.normal(prng.key(0), (3, 5), device="meta")
    assert meta.is_meta and meta.shape == (3, 5)
    launches = dict(kthreefry.launches)
    prng.normal(prng.key(0), (8,), device="cpu")
    assert kthreefry.launches == launches


def test_draws_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prng.normal(prng.key(0), (2,))


# --------------------------------------------------------------------- #
# the port's own draws against the reference's
# --------------------------------------------------------------------- #
def _reference_params(jcfg, seed=0) -> dict:
    jparams = jax.jit(JModel(jcfg).init_params)(jax.random.PRNGKey(seed))
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))


def _assert_leaf_matches(name, got, want, got_f32):
    """f32 leaves within ``NORMAL_REL``; ones and zeros exact; bf16 leaves
    equal but at rounding boundaries, which lie 1 ulp apart. Returns the
    count of those."""
    assert got.dtype == want.dtype and got.shape == want.shape, name
    if got.dtype == torch.float32:
        if bool(torch.all((want == 0) | (want == 1))):
            assert torch.equal(got, want), name
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=NORMAL_REL, atol=0, err_msg=name)
        return 0
    differ = got != want
    a, b = got[differ].float(), want[differ].float()
    x = got_f32[differ].double()
    mid = (a.double() + b.double()) / 2
    ulp = torch.finfo(torch.bfloat16).eps * torch.maximum(a.abs(), b.abs())
    assert bool(torch.all((a - b).abs() <= ulp)), name
    assert bool(torch.all((x - mid).abs() <= NORMAL_REL * x.abs())), name
    return int(differ.sum())


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_init_params_from_key_0_equal_the_reference(arch):
    """Reduced (f32): every leaf of ``Model.init_params(key(0))`` against
    ``repro``'s ``init_params(PRNGKey(0))`` (largest difference found over
    the ten: 3.0e-7 relative)."""
    got = Model(get_arch(arch).reduced(), device="cpu").init_params(
        prng.key(0)).state_dict()
    want = _reference_params(jget_arch(arch).reduced())
    assert set(got) == set(want)
    for name in want:
        _assert_leaf_matches(name, got[name], want[name], None)


@pytest.mark.parametrize("arch", ["yi-6b", "grok-1-314b", "mamba2-130m",
                                  "hymba-1.5b", "musicgen-large"])
def test_bf16_init_params_equal_the_reference_but_at_rounding_boundaries(
        arch):
    """The arch's published attention, expert and SSM geometry in bf16 at
    a small width: bf16 leaves equal JAX's except where the f32 draw sits
    at a rounding boundary (counted; none at this size and seed), f32
    leaves (the SSM's ``conv_w``) within ``NORMAL_REL``."""
    small = dict(SMALL_BF16, d_ff=SMALL_BF16["d_ff"]
                 if get_arch(arch).d_ff else 0)
    tcfg = dataclasses.replace(get_arch(arch), **small)
    assert tcfg.dtype == "bfloat16"
    model = Model(tcfg, device="cpu").init_params(prng.key(0))
    f32 = Model(dataclasses.replace(tcfg, dtype="float32"),
                device="cpu").init_params(prng.key(0)).state_dict()
    want = _reference_params(dataclasses.replace(jget_arch(arch), **small))
    got = model.state_dict()
    flips = sum(_assert_leaf_matches(n, got[n], want[n], f32[n])
                for n in want)
    total = sum(t.numel() for t in got.values()
                if t.dtype == torch.bfloat16)
    assert total > 10 ** 6
    assert flips <= total * 1e-5, (flips, total)


@pytest.mark.parametrize("cfg", [NARROW, MINILM_L6], ids=["narrow", "minilm"])
def test_encoder_params_from_key_0_equal_the_reference(cfg):
    got = init_encoder_params(prng.key(0), cfg, device="cpu")
    want = jax.jit(lambda k: jenc.init_encoder_params(k, cfg))(
        jax.random.PRNGKey(0))
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert set(flat_got) == set(flat_want)
    for path, leaf in flat_want.items():
        _assert_leaf_matches(jax.tree_util.keystr(path), flat_got[path],
                             torch.from_numpy(np.array(leaf)), None)


def test_train_driver_own_draw_matches_the_reference_losses():
    """``launch.train`` on reduced mamba2 with no ``params=`` (its own draw
    from key 0) against ``repro.launch.train``'s jitted step loop on its
    ``init_params(PRNGKey(0))``: four steps' losses within ``LOSS_TOL``."""
    steps, batch, seq = 4, 2, 32
    out = ttrain.train("mamba2-130m", steps=steps, batch=batch, seq=seq,
                       device="cpu", log=lambda *a: None)
    jcfg = jget_arch("mamba2-130m").reduced()
    jm = JModel(jcfg)
    params = jm.init_params(jax.random.PRNGKey(0))
    ocfg = jopt.AdamWConfig(lr=3e-3, warmup_steps=max(steps // 20, 1),
                            total_steps=steps)
    opt = jopt.init_adamw(params)

    @jax.jit
    def step(params, opt, tokens):
        loss, grads = jax.value_and_grad(
            lambda p: jm.loss_fn(p, tokens, remat=True))(params)
        params, opt, _ = jopt.adamw_update(ocfg, params, grads, opt)
        return params, opt, loss

    batches = jmake_batches(JTokenizer(vocab_size=jcfg.vocab),
                            jbuild_corpus(500), batch, seq, jcfg.vocab)
    want = []
    for _ in range(steps):
        params, opt, loss = step(params, opt, next(batches))
        want.append(float(loss))
    np.testing.assert_allclose(out["loss"], want, rtol=0, atol=LOSS_TOL)
    assert want[-1] < want[0]


def test_serve_backend_model_own_draw_matches_the_reference():
    """``launch.serve --backend model`` (reduced yi-6b, f32, CPU) with its
    own weights from key 0 against ``repro.launch.serve``'s from
    ``PRNGKey(0)``: hits, answers and scores request by request. A greedy
    token could flip only where the reference's top-two logit gap is under
    1e-4; such a request would be named in the failure, and none is."""
    kw = dict(corpus=20, queries=5, batch=16)
    jparams = JModel(jget_arch("yi-6b").reduced()).init_params(
        jax.random.PRNGKey(0))
    jeng, jresp = jax_serve("yi-6b", jparams=jparams, **kw)
    teng, treq = serve.build(device="cpu", backend="model", arch="yi-6b",
                             log=lambda *a: None, **kw)
    tresp = teng.process(treq)
    assert len(tresp) == len(jresp) == 20
    assert any(not r.cached for r in tresp) and any(r.cached for r in tresp)
    differ = [i for i, (j, t) in enumerate(zip(jresp, tresp))
              if (t.cached, t.answer) != (j.cached, j.answer)]
    assert not differ, f"answers differ at requests {differ}: check the " \
        "reference's top-two logit gaps there"
    for j, t in zip(jresp, tresp):
        assert abs(t.score - j.score) <= 1e-5
    assert teng.backend.calls == jeng.backend.calls
