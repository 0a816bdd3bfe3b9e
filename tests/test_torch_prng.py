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

Every test runs in both of jax's threefry modes (the fixture sets
``jax_threefry_partitionable`` and the port's mode alike): partitionable,
the default from jax 0.5 on, and original, the default of jax 0.4.
"""
import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import dtypes as jdtypes
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

ROOT = Path(__file__).resolve().parents[1]
NORMAL_REL = 1e-5
LOSS_TOL = 1e-4
SEEDS = (0, 1, 17, 42, 2 ** 31 + 5, 2 ** 32 - 1)
NARROW = EncoderConfig(vocab=512, d_model=64, n_layers=2, n_heads=4,
                       d_ff=128, max_len=32)


@pytest.fixture(autouse=True, params=[True, False],
                ids=["partitionable", "original"])
def threefry_mode(request):
    """Both threefry modes, set alike in jax and in the port; yields the
    mode (True: partitionable)."""
    was = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    with prng.partitionable(request.param):
        yield request.param
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
    if prng.is_partitionable():
        # fold-like splitting: fold_in(k, i) is key i of a split
        np.testing.assert_array_equal(prng.fold_in(k, 5), prng.split(k, 8)[5])
    else:
        # the original split of one hashes the pair (0, 1), as fold_in(k, 1)
        np.testing.assert_array_equal(prng.fold_in(k, 1), prng.split(k, 1)[0])
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


def _jax_bits_at(k, total: int, offset: int, n: int) -> np.ndarray:
    """Elements ``offset`` .. ``offset + n - 1`` of ``jax.random.bits(k,
    (total,))`` in the mode jax runs, built from jax's own pieces on
    explicit counters. Partitionable: ``threefry2x32_p`` of each element's
    64-bit index split into words. Original: the block keys from
    ``_threefry_split_original`` (the draw's key where the draw has no full
    block of 2^32 - 1), then ``threefry_2x32`` of the explicit counters [p;
    q] of the elements' pairs (p, q) in their block of size m, p = i or i
    - ceil(m / 2), q = p + ceil(m / 2) or the odd size's pad 0, which
    returns their first words then their second."""
    c = np.arange(offset, offset + n, dtype=np.uint64)
    jk = jnp.asarray(np.asarray(k, dtype=np.uint32))
    if jax.config.jax_threefry_partitionable:
        b0, b1 = jprng.threefry2x32_p.bind(
            jk[0], jk[1], jnp.asarray((c >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((c & np.uint64(0xFFFFFFFF)).astype(np.uint32)))
        return np.asarray(b0 ^ b1).astype(np.int64)
    block = 2 ** 32 - 1
    nblocks, rem = divmod(total, block)
    keys = jprng._threefry_split_original(jk, (nblocks + 1,)) if nblocks \
        else jk[None]
    out = np.empty(n, dtype=np.int64)
    for b in np.unique(c // np.uint64(block)):
        at = np.flatnonzero(c // np.uint64(block) == b)
        m = block if b < nblocks else rem
        half = np.uint64(-(-m // 2))
        i = c[at] - b * np.uint64(block)
        upper = i >= half
        p = np.where(upper, i - half, i)
        q = np.where(p + half < m, p + half, 0)
        y = np.asarray(jprng.threefry_2x32(
            keys[int(b)], jnp.asarray(np.concatenate([p, q]).astype(
                np.uint32)))).astype(np.int64)
        out[at] = np.where(upper, y[len(at):], y[:len(at)])
    return out


@pytest.mark.parametrize("total", [5, 1000, 1001])
def test_jax_bits_at_equals_jax_random_bits(total):
    """``_jax_bits_at``, which the tests past 2^32 read, is
    ``jax.random.bits`` where a whole draw fits in the test."""
    jk = jax.random.PRNGKey(11)
    whole = np.asarray(jax.random.bits(jk, (total,))).astype(np.int64)
    for off, n in ((0, total), (total // 2 - 1, 2), (total - 2, 2)):
        np.testing.assert_array_equal(
            _jax_bits_at(_u32(jk), total, off, n), whole[off:off + n])


def test_bits_past_two_to_the_32_equal_jax_threefry_on_explicit_counts():
    """Elements past 2^32 of a draw (grok-1's whole-depth MoE stacks pass
    2^32 elements): in partitionable mode a flat counter past 2^32 takes
    the high word, as JAX's ``iota_2x32_shape`` splits it; in original
    mode they lie in the blocks past the first. Held against jax's
    threefry on the explicit words (``_jax_bits_at``)."""
    k, total = prng.key(7), 3 * 2 ** 32 + 5000
    for off in (2 ** 32 - 500, 2 ** 32 + 12345, 3 * 2 ** 32 + 1):
        np.testing.assert_array_equal(
            prng.bits(k, (1000,), offset=off, total=total,
                      device="cpu").numpy(),
            _jax_bits_at(k, total, off, 1000))


# llama4's stacked expert leaf at 2 layers (two block ends of the
# original layout), grok-1's (one block, h past 2^30), and odd sizes
BLOCK_TOTALS = (2 * 128 * 5120 * 8192, 2 * 8 * 6144 * 32768,
                2 * (2 ** 32 - 1) + 12345, 2 ** 32 - 1, 2 ** 32 + 1)


@pytest.mark.parametrize("total", BLOCK_TOTALS)
def test_bits_around_block_ends_h_and_the_odd_pad_equal_jax(total):
    """Windows of 64 around each original-layout block end (multiples of
    2^32 - 1), around each block's h = ceil(size / 2) and at the draw's
    end (the odd block's pad), as bits and as [0, 1) uniforms, against
    ``_jax_bits_at`` in the mode the fixture sets."""
    k = prng.key(5)
    for point in ref.threefry_seams(total):
        off = min(max(point - 32, 0), total - 64)
        got = prng.bits(k, (64,), offset=off, total=total, device="cpu")
        want = _jax_bits_at(k, total, off, 64)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(off))
        u = prng.uniform(k, (64,), offset=off, total=total, device="cpu")
        f = (want >> 9 | 0x3F800000).astype(np.uint32).view(np.float32) - 1
        np.testing.assert_array_equal(u.numpy(), np.maximum(f, 0))


@pytest.mark.parametrize("total", [2500, 3000, 2001])
def test_blocks_equal_jax_own_blocking_at_a_small_block(total,
                                                       threefry_mode):
    """The blocking itself against jax's own code, with both sides' block
    of 2^32 - 1 cut to 1,000 elements: in original mode against
    ``_threefry_random_bits_original`` (whole draws of two and three
    blocks, odd and even remainders, windows across the block ends); in
    partitionable mode the cut changes nothing, against
    ``jax.random.bits``."""
    jk = jax.random.PRNGKey(9)
    small = types.SimpleNamespace(**vars(jdtypes))
    small.iinfo = lambda t: types.SimpleNamespace(max=1000) \
        if t is np.uint32 else jdtypes.iinfo(t)
    with mock.patch.object(jprng, "dtypes", small):
        want = np.asarray(
            jax.random.bits(jk, (total,)) if threefry_mode
            else jprng._threefry_random_bits_original(jk, 32, (total,))
        ).astype(np.int64)
    k = _u32(jk)
    with mock.patch.object(ref, "THREEFRY_BLOCK", 1000):
        np.testing.assert_array_equal(
            prng.bits(k, (total,), device="cpu").numpy(), want)
        for off, n in ((990, 20), (1999, 2), (0, 1500), (total - 7, 7)):
            np.testing.assert_array_equal(
                prng.bits(k, (n,), offset=off, total=total,
                          device="cpu").numpy(), want[off:off + n])


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
    total = whole.numel()
    # the original layout's h is 1,920: windows below, across and past it
    for off, n in ((0, 1), (96, 7 * 96), (1001, 2839), (1900, 40)):
        assert torch.equal(draw(shape=(n,), offset=off, total=total),
                           whole[off:off + n])
    # chunks of the plain version end where they end: the same numbers
    assert ref.THREEFRY_CHUNK < 2 ** 21
    total = ref.THREEFRY_CHUNK + 100
    big = draw(shape=(ref.THREEFRY_CHUNK + 5,), offset=11, total=total)
    assert torch.equal(big[-6:], draw(shape=(6,), total=total,
                                      offset=10 + ref.THREEFRY_CHUNK))


def test_an_offset_draw_needs_the_whole_size_in_original_mode(
        threefry_mode):
    """The original layout pairs a draw's elements by its whole size, so
    a draw at an offset without ``total`` raises there; partitionable
    draws do not need it. Past ``total`` raises in both."""
    k = prng.key(4)
    if threefry_mode:
        assert torch.equal(prng.bits(k, (5,), offset=3, device="cpu"),
                           prng.bits(k, (5,), offset=3, total=99,
                                     device="cpu"))
    else:
        with pytest.raises(ValueError, match="total="):
            prng.normal(k, (5,), offset=3, device="cpu")
        with pytest.raises(ValueError, match="total="):
            ops.threefry_fill(torch.empty(2), (0, 1), offset=1,
                              layout="original")
    # a draw from element 0 is the whole draw of its own size
    assert torch.equal(prng.bits(k, (6,), offset=0, device="cpu"),
                       prng.bits(k, (6,), device="cpu"))
    with pytest.raises(ValueError, match="lie past"):
        prng.uniform(k, (5,), offset=3, total=7, device="cpu")
    with pytest.raises(ValueError, match="layout"):
        ops.threefry_fill(torch.empty(2), (0, 1), layout="foldlike")


ENV_CHECK = """
import importlib, os, jax
from repro_torch import prng
assert prng.is_partitionable() is jax.config.jax_threefry_partitionable
print(prng.is_partitionable())
for val, want in (("off", False), ("No", False), ("TRUE", True),
                  ("y", True), (None, True)):
    os.environ.pop(prng.ENV, None)
    if val is not None:
        os.environ[prng.ENV] = val
    assert importlib.reload(prng).is_partitionable() is want, val
os.environ[prng.ENV] = "maybe"
try:
    importlib.reload(prng)
except ValueError as e:
    print("raises", e)
"""


def test_env_sets_the_default_mode_in_both_packages(threefry_mode):
    """``JAX_THREEFRY_PARTITIONABLE`` (here "1" or "0", as the fixture's
    mode) sets the default of jax's flag and of the port's mode alike in a
    fresh process; the port reads jax's truth values, unset is on, and
    anything else raises at import."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_THREEFRY_PARTITIONABLE=str(int(threefry_mode)),
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", ENV_CHECK], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    first, second = out.stdout.splitlines()
    assert first == str(threefry_mode)
    assert second.startswith("raises invalid truth value 'maybe'")


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
