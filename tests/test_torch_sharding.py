"""The port's sharding specs (``repro_torch.launch.sharding``) against the
JAX package's ``PartitionSpec``s, leaf by leaf, for every arch: the
parameters and AdamW moments on the single-pod and multi-pod data axes,
the inputs of every shape (batches that divide over the data axes and
one that does not), and the decode caches, quantized or not; and
``placements``, which turns a spec into DTensor placements. JAX's
``PartitionSpec`` needs no devices, so this runs in one process."""
import dataclasses

import pytest
from torch.distributed.tensor import Replicate, Shard

from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs import get_arch as jget_arch
from repro.launch import sharding as jshlib
from repro_torch.configs import ARCHITECTURES, INPUT_SHAPES, get_arch
from repro_torch.launch import sharding as shlib
from repro_torch.models.model import Model

DPS = [("data",), ("pod", "data")]


def _entry(e):
    if e is None:
        return None
    return (e,) if isinstance(e, str) else tuple(e)


def _norm(spec, ndim):
    """A spec as a tuple of ``ndim`` entries, each a tuple of axis names
    or None (a JAX ``P`` may name fewer dims than the leaf has)."""
    entries = [_entry(e) for e in tuple(spec)]
    assert len(entries) <= ndim, (spec, ndim)
    return tuple(entries + [None] * (ndim - len(entries)))


def _flat(tree, prefix=""):
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(_flat(leaf, f"{prefix}{name}."))
        else:
            out[prefix + name] = leaf
    return out


@pytest.mark.parametrize("dp", DPS, ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", list(ARCHITECTURES))
def test_param_and_opt_specs_match_jax(arch, dp):
    ndim = {n: p.dim() for n, p in
            Model(get_arch(arch), device="meta").named_parameters()}
    ours = shlib.param_pspecs(get_arch(arch), dp)
    theirs = _flat(jshlib.param_pspecs(jget_arch(arch), dp))
    assert set(ours) == set(theirs) == set(ndim)
    for name, spec in ours.items():
        assert len(spec) == ndim[name], name
        assert _norm(spec, ndim[name]) == _norm(theirs[name], ndim[name]), \
            name
    opt, jopt = shlib.opt_pspecs(ours), jshlib.opt_pspecs(
        jshlib.param_pspecs(jget_arch(arch), dp))
    assert opt.step == tuple(jopt.step) == ()
    for moments, jmoments in ((opt.m, jopt.m), (opt.v, jopt.v)):
        jm = _flat(jmoments)
        assert {n: _norm(s, ndim[n]) for n, s in moments.items()} == \
            {n: _norm(s, ndim[n]) for n, s in jm.items()}


@pytest.mark.parametrize("arch", list(ARCHITECTURES))
def test_batch_specs_match_jax(arch):
    """Every shape: train_4k (B=256), prefill_32k (32) and decode_32k
    (128) divide over both data-axis sets, long_500k (B=1) does not."""
    c, jc = get_arch(arch), jget_arch(arch)
    for name, shape in INPUT_SHAPES.items():
        for dp in DPS:
            ours = shlib.batch_pspecs(c, shape, dp)
            theirs = jshlib.batch_pspecs(jc, JSHAPES[name], dp)
            assert set(ours) == set(theirs)
            for leaf, spec in ours.items():
                assert _norm(spec, len(spec)) == \
                    _norm(theirs[leaf], len(spec)), (name, dp, leaf)
            divides = shlib._divisible(shape.global_batch, dp)
            assert divides == (name != "long_500k")
            assert ours["tokens"][0] == (dp if divides else None)


@pytest.mark.parametrize("arch", list(ARCHITECTURES))
def test_decode_cache_specs_match_jax(arch):
    c, jc = get_arch(arch), jget_arch(arch)
    for batch in (128, 1):
        for dp in DPS:
            for quantized in (False, True):
                ours = shlib.decode_cache_pspecs(c, batch, dp, quantized)
                theirs = jshlib.decode_cache_pspecs(jc, batch, dp, quantized)
                where = (batch, dp, quantized)
                if theirs.kv is None:
                    assert ours.kv is None
                else:
                    for leaf, ndim in (("k", 5), ("v", 5), ("slot_pos", 1),
                                       ("pos", 0)):
                        assert _norm(getattr(ours.kv, leaf), ndim) == _norm(
                            getattr(theirs.kv, leaf), ndim), (where, leaf)
                    for leaf in ("k_scale", "v_scale"):
                        mine = getattr(ours.kv, leaf)
                        if quantized:
                            assert _norm(mine, 4) == _norm(
                                getattr(theirs.kv, leaf), 4), (where, leaf)
                        else:   # JAX keeps a zero-size placeholder: P()
                            assert mine is None
                            assert tuple(getattr(theirs.kv, leaf)) == ()
                    assert ours.kv.k[2] == "model"   # sequence over model
                if theirs.ssm is None:
                    assert ours.ssm is None
                else:
                    for leaf, ndim in (("conv", 4), ("ssd", 5)):
                        assert _norm(getattr(ours.ssm, leaf), ndim) == _norm(
                            getattr(theirs.ssm, leaf), ndim), (where, leaf)


@dataclasses.dataclass
class _Names:
    """Stands in for a DeviceMesh: ``placements`` reads only the names."""
    mesh_dim_names: tuple


def test_placements():
    pod, multi = _Names(("data", "model")), _Names(("pod", "data", "model"))
    assert shlib.placements(pod, (None, None, None, "model")) == (
        Replicate(), Shard(3))
    assert shlib.placements(pod, (("data",), None)) == (Shard(0),
                                                        Replicate())
    assert shlib.placements(multi, (("pod", "data"), "model", None)) == (
        Shard(0), Shard(0), Shard(1))
    assert shlib.placements(multi, (None, None)) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        shlib.placements(multi, (("data", "pod"), None))
    with pytest.raises(ValueError, match="twice"):
        shlib.placements(pod, ("model", "model"))


def test_divisible_follows_the_mesh_where_given():
    assert shlib._divisible(32, ("data",))
    assert not shlib._divisible(32, ("pod", "data", "model"))
    assert not shlib._divisible(8, ("data",))       # under the axis size
    assert not shlib._divisible(8, None)

    class Mesh:
        mesh_dim_names = ("data", "model")

        @staticmethod
        def size(i):
            return 2

    assert shlib._divisible(8, ("data",), Mesh())
    assert not shlib._divisible(3, ("data",), Mesh())
