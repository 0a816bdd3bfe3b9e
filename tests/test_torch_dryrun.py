"""The shape dry run (``repro_torch.launch.dryrun``) on the CPU: every
arch's train, prefill and decode steps on the ``meta`` device give the
shapes and dtypes that ``jax.eval_shape`` gives for the JAX package's
``loss_fn`` (and its gradients), ``forward`` and ``decode_step``, at each
arch's reduced config in its own dtype and a small shape of each kind;
the command line on one real pair; a pair that fails on ``meta`` recorded
as failed with the op that stopped it; and the sharded cache pair on the
CPU at a small capacity."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs.base import InputShape as JInputShape
from repro.launch import sharding as jshlib
from repro.models.model import Model as JModel
from repro_torch.configs import ARCHITECTURES, get_arch, get_shape
from repro_torch.configs.base import InputShape
from repro_torch.kernels import ref
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"train": (2, 48), "prefill": (2, 48), "decode": (2, 40)}  # (B, L)
JDT = {jnp.dtype(jnp.float32): torch.float32,
       jnp.dtype(jnp.bfloat16): torch.bfloat16,
       jnp.dtype(jnp.int8): torch.int8, jnp.dtype(jnp.int32): torch.int32}


def _configs(arch):
    """Both packages' reduced config of ``arch`` in the arch's own dtype."""
    full = get_arch(arch)
    return (dataclasses.replace(full.reduced(), dtype=full.dtype),
            dataclasses.replace(jget_arch(arch).reduced(), dtype=full.dtype))


def _spec(x):
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype
    return tuple(x.shape), JDT[jnp.dtype(x.dtype)]


def _jax_inputs(c, shape):
    b, s = shape.global_batch, shape.seq_len
    books = (c.n_codebooks,) if c.n_codebooks > 1 else ()
    text = 1 if shape.kind == "decode" else s - c.n_prefix
    tokens = jax.ShapeDtypeStruct((b, text) + books, jnp.int32)
    pre = jax.ShapeDtypeStruct((b, c.n_prefix, c.d_model), jnp.float32) \
        if c.n_prefix and shape.kind != "decode" else None
    return tokens, pre


def _check_caches(ours, theirs, quantized):
    if theirs.kv is None:
        assert ours.kv is None
    else:
        for leaf in ("k", "v", "slot_pos") + (("k_scale", "v_scale")
                                              if quantized else ()):
            assert _spec(getattr(ours.kv, leaf)) \
                == _spec(getattr(theirs.kv, leaf)), leaf
    if theirs.ssm is None:
        assert ours.ssm is None
    else:
        for leaf in ("conv", "ssd"):
            assert _spec(getattr(ours.ssm, leaf)) \
                == _spec(getattr(theirs.ssm, leaf)), leaf


def _flat(tree, prefix=""):
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(_flat(leaf, f"{prefix}{name}."))
        else:
            out[prefix + name] = leaf
    return out


# every arch at each kind, and int8 KV caches where the arch has a KV cache
CASES = [(a, kind, "") for a in ARCHITECTURES
         for kind in ("train", "prefill", "decode")] + [
    (a, "decode", "kvq") for a, c in ARCHITECTURES.items()
    if c.has_attention]


@pytest.mark.parametrize("arch,kind,variant", CASES)
def test_meta_step_matches_jax_eval_shape(arch, kind, variant):
    c, jc = _configs(arch)
    b, s = SMALL[kind]
    shape = InputShape(f"small_{kind}", s, b, kind)
    jshape = JInputShape(f"small_{kind}", s, b, kind)
    fn, args = dryrun.build_step(c, shape, variant)
    assert all(t.device.type == "meta" for t in args[-1].values())
    out = fn(*args)

    model = JModel(jc)
    params = jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0)))
    tokens, pre = _jax_inputs(jc, jshape)
    if kind == "train":
        loss, grads = jax.eval_shape(
            lambda p, t, e: jax.value_and_grad(
                lambda q: model.loss_fn(q, t, prefix_emb=e, remat=True))(p),
            params, tokens, pre)
        _, _, our_loss, our_grads = out
        assert _spec(our_loss) == _spec(loss) == ((), torch.float32)
        want = {n: _spec(g) for n, g in _flat(grads).items()}
        assert {n: _spec(g) for n, g in our_grads.items()} == want
        assert {n: _spec(p) for n, p in args[0].items()} == want
        return
    if kind == "prefill":
        logits, caches, _ = jax.eval_shape(
            lambda p, t, e: model.forward(
                p, t, prefix_emb=e, collect_cache=True, cache_size=s,
                logits_last_only=True), params, tokens, pre)
        our_logits, our_caches = out
    else:
        caches_in = jshlib.decode_cache_specs(jc, jshape,
                                              quantized=variant == "kvq")
        _check_caches(args[0], caches_in, variant == "kvq")
        logits, caches = jax.eval_shape(
            lambda p, k, t: model.decode_step(p, k, t), params, caches_in,
            tokens)
        our_logits, our_caches = out
    assert _spec(our_logits) == _spec(logits)
    _check_caches(our_caches, caches, variant == "kvq")


def test_command_line_one_pair(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-130m", "--shape", "decode_32k", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "1/1 dry-runs succeeded" in r.stdout
    art = json.loads((tmp_path / "mamba2-130m_decode_32k_one_card.json")
                     .read_text())
    assert art["ok"] and art["chips"] == 1
    assert art["collectives"]["total_bytes"] == 0
    assert art["op_histogram"] and art["counted_flops"] > 0
    assert art["param_bytes"] > 0 and art["cache_bytes"] > 0
    assert art["roofline"]["dominant"] == "memory"
    assert art["flops"] == pytest.approx(art["roofline"]["hlo_gflops"] * 1e9)


def test_failing_pair_is_recorded(tmp_path, monkeypatch, capsys):
    """An op that reads a value on the host stops a meta run: the pair is
    written with ``ok: false``, its error and that op, and the exit status
    is 1 (``ref.ivf_topk_ref`` calls ``nonzero``)."""
    def step(config, shape, variant="", mesh=None):
        q = torch.empty((4, 8), device="meta")
        keys = torch.empty((16, 8), device="meta")
        cand = torch.empty((4, 6), dtype=torch.int32, device="meta")
        return (lambda: ref.ivf_topk_ref(q, keys, cand, 2)), ()

    monkeypatch.setattr(dryrun, "build_step", step)
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "yi-6b", "--shape", "decode_32k", "--out",
                     str(tmp_path)])
    assert exc.value.code == 1
    assert "0/1 dry-runs succeeded" in capsys.readouterr().out
    art = json.loads((tmp_path / "yi-6b_decode_32k_one_card.json")
                     .read_text())
    assert art["ok"] is False
    assert art["failed_op"] == "nonzero"
    assert "NotImplementedError" in art["error"] and art["traceback"]


@pytest.mark.parametrize("variant,key_bytes", [("", 4), ("int8", 1)])
def test_cache_pair_on_cpu(tmp_path, variant, key_bytes):
    capacity, batch = 4096, 64
    art = dryrun.run_cache(str(tmp_path), variant, "cpu", capacity=capacity,
                           batch=batch, steps=2, verbose=False)
    assert art["ok"], art.get("traceback")
    assert art["shards"] == 4 and art["device"] == "cpu"
    assert art["slab_bytes"] == capacity * dryrun.CACHE_DIM * key_bytes
    # the warm-up step inserts the batch, and the same queries then hit
    assert art["entries"] == batch and art["hits_last_step"] == batch
    assert art["step_ms"] > 0
    terms = art["roofline"]
    assert terms["memory_s"] == art["slab_bytes"] / 3.35e12
    assert terms["compute_s"] == 2.0 * batch * capacity * 384 / 989e12
    assert terms["collective_s"] == 0.0
    tag = "semantic-cache_lookup-insert_one_card" + (
        f"__{variant}" if variant else "")
    assert json.loads((tmp_path / f"{tag}.json").read_text())["ok"]



def test_variants_on_one_card_are_no_ops():
    """``attn`` and ``attn-sp`` are redistributions on a mesh; on one card
    they are no-ops, as the reference's ``_constrain`` without a mesh."""
    outs = {}
    for variant in ("", "attn", "attn-sp"):
        fn, args = dryrun.build_fn_and_args("yi-6b", "decode_32k", variant)
        logits, _ = fn(*args)
        outs[variant] = _spec(logits)
    assert outs["attn"] == outs["attn-sp"] == outs[""]
    with pytest.raises(ValueError, match="unknown"):
        dryrun.build_fn_and_args("yi-6b", "decode_32k", "fast")


# --------------------------------------------------------------------- #
# the production meshes: each in its own fake world, in subprocesses
# --------------------------------------------------------------------- #
MESH_SIZES = {"pod_16x16": {"data": 16, "model": 16},
              "multipod_2x16x16": {"pod": 2, "data": 16, "model": 16}}
PRODUCTION = [("mamba2-130m", "decode_32k"), ("yi-6b", "prefill_32k")]


def _cli(args, out):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out",
         str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def production(tmp_path_factory):
    root = tmp_path_factory.mktemp("meshes")
    procs = {
        "mamba2": _cli(["--mesh", "pod_16x16", "--arch", "mamba2-130m",
                        "--shape", "decode_32k"], root),
        "yi": _cli(["--both-meshes", "--arch", "yi-6b", "--shape",
                    "prefill_32k"], root),
        "multi": _cli(["--multi-pod", "--arch", "mamba2-130m", "--shape",
                       "decode_32k"], root)}
    logs = {}
    for name, proc in procs.items():
        logs[name], _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, logs[name][-4000:]
    arts = {(a, s, m): json.loads(
        (root / f"{a}_{s}_{m}.json").read_text())
        for a, s in PRODUCTION for m in MESH_SIZES}
    return arts, logs


def _jax_local_param_bytes(arch, mesh):
    """Rank 0's parameter bytes by the JAX package's specs: each leaf's
    dims ceil-divided by the product of the axes its spec names."""
    sizes = MESH_SIZES[mesh]
    dp = ("pod", "data") if "pod" in sizes else ("data",)
    jc = jget_arch(arch)
    shapes = _flat(jax.eval_shape(
        lambda: JModel(jc).init_params(jax.random.PRNGKey(0))))
    specs = _flat(jshlib.param_pspecs(jc, dp))
    total = 0
    for name, leaf in shapes.items():
        spec = tuple(specs[name]) + (None,) * (len(leaf.shape) - len(
            tuple(specs[name])))
        n = 1
        for dim, entry in zip(leaf.shape, spec):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else tuple(entry))
            k = 1
            for a in axes:
                k *= sizes[a]
            n *= -(-dim // k)
        total += n * jnp.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("mesh", list(MESH_SIZES))
@pytest.mark.parametrize("arch,shape", PRODUCTION)
def test_production_mesh_pair(production, arch, shape, mesh):
    art = production[0][(arch, shape, mesh)]
    assert art["ok"], art.get("traceback")
    assert art["chips"] == (512 if mesh.startswith("multipod") else 256)
    assert art["n_mp"] == 16 and art["n_dp"] * 16 == art["chips"]
    assert art["param_bytes"] == _jax_local_param_bytes(arch, mesh)
    assert art["roofline"]["chips"] == art["chips"]
    coll = art["collectives"]
    assert coll["total_bytes"] == sum(coll["bytes"].values()) > 0
    assert set(coll["static_count"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    assert art["memory"]["argument_size_in_bytes"] >= art["param_bytes"]
    assert art["roofline"]["collective_s"] == pytest.approx(
        coll["total_bytes"] / 450e9)


@pytest.mark.parametrize("arch,shape", PRODUCTION)
def test_data_sharded_bytes_halve_on_the_multipod(production, arch, shape):
    """The batch splits over 16 data ranks on the pod and 32 on the
    multipod: the decode caches and the prefill's outputs (last-position
    logits, caches; less the replicated (S,) int32 ``slot_pos``) halve a
    chip; the parameters do not."""
    arts = production[0]
    pod, multi = (arts[(arch, shape, m)] for m in MESH_SIZES)
    if shape.startswith("decode"):
        assert pod["cache_bytes"] == 2 * multi["cache_bytes"] > 0
    else:
        slot_pos = get_shape(shape).seq_len * 4
        assert pod["memory"]["output_size_in_bytes"] - slot_pos == 2 * (
            multi["memory"]["output_size_in_bytes"] - slot_pos) > 0
    assert pod["param_bytes"] == multi["param_bytes"]


def test_multi_pod_command_line(production):
    assert "1/1 dry-runs succeeded" in production[1]["multi"]
    assert "2/2 dry-runs succeeded" in production[1]["yi"]
