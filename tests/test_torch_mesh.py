"""The port's multi-chip path on a (2, 2) mesh of 4 gloo ranks on the CPU,
against the unsharded port and the JAX package.

One spawn for the module: ``tests/torch_mesh_worker.py`` runs as 4
processes joined through a file store in a tmp dir (no TCP port: pytest
runs with several workers), reads the inputs written here and leaves its
results in a file. The JAX package's ``moe_ffn_sharded`` runs meanwhile
in a subprocess on 4 forced host devices (``tests/test_distributed.py``'s
way), and its unsharded forwards here. Held:
  * the sharded MoE against the reference's sharded form at capacity
    factor 1.25, where tokens drop (capacity from the local token count:
    the same expert slots, y within 1e-5), and against ``moe_ffn`` at 8.0
    (2e-3, the JAX test's bound);
  * reduced yi-6b, grok-1 and hymba (5 heads of 64 over 2 model ranks, so
    a projection's shard ends mid-head) forward and decode, against the
    unsharded port and the JAX forward: within 1e-5 of the largest
    |logit|, f32;
  * the ``attn`` and ``attn-sp`` variants move no logit;
  * decode attention with the cache's sequence split over ``model`` (each
    rank's part merged by its log-sum-exp): f32 and int8 caches, a window
    with sinks, a rank that sees no slot and a row that sees none, against
    the unsharded port and JAX's ``decode_attention`` (the Pallas kernel
    in interpret mode where nothing is visible: 0) within 1e-5 of the
    largest output;
  * three AdamW steps of reduced yi-6b: the losses within 1e-5 relative of
    the unsharded port's, the gradient norm global (the unsharded one's),
    the last loss at most the first + 0.5.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch as jget_arch
from repro.models.model import Model as JModel

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_mesh_worker.py"
sys.path.insert(0, str(ROOT / "tests"))
import torch_mesh_worker as worker  # noqa: E402

TOL = 1e-5                       # of the largest |logit|, f32
MOE_T, MOE_D, MOE_F, MOE_E = 16, 32, 64, 4
TIMEOUT = 300

JAX_MOE = """
import sys
import jax, numpy as np
from repro.models.moe import dispatch_indices, moe_ffn_sharded, router
inp = np.load(sys.argv[1])
mesh = jax.make_mesh((2, 2), ("data", "model"))
fn = moe_ffn_sharded(mesh, ("data",), ("model",))
ops = [inp["moe_" + n] for n in ("x", "wr", "wg", "wu", "wd")]
out = {}
for cf in (1.25, 8.0):
    y, aux = jax.jit(lambda *a: fn(*a, topk=2, capacity_factor=cf))(*ops)
    out[f"y_{cf}"] = np.asarray(y)
    out[f"aux_{cf}"] = np.asarray(aux)
x, wr = ops[0], ops[1]
e = ops[2].shape[0]
for i, xs in enumerate(np.split(x, 2)):
    _, experts, _ = router(xs, wr, 2)
    cap = max(int(np.ceil(xs.shape[0] * 2 / e * 1.25)), 1)
    out[f"slots_{i}"] = np.asarray(dispatch_indices(experts, e, cap)[0])
np.savez(sys.argv[2], **out)
"""


def _jax_config(arch):
    return dataclasses.replace(jget_arch(arch).reduced(),
                               **worker.ARCHS[arch])


def _flat(tree, prefix):
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(_flat(leaf, f"{prefix}/{name}"))
        else:
            out[f"{prefix}/{name}"] = np.asarray(leaf)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(0)
    inputs = {"tokens": rng.integers(
        0, 1024, (4, worker.PREFILL + worker.DECODE)).astype(np.int32)}
    for name, shape, scale in (("x", (MOE_T, MOE_D), 1.0),
                               ("wr", (MOE_D, MOE_E), 0.1),
                               ("wg", (MOE_E, MOE_D, MOE_F), 0.1),
                               ("wu", (MOE_E, MOE_D, MOE_F), 0.1),
                               ("wd", (MOE_E, MOE_F, MOE_D), 0.1)):
        inputs[f"moe_{name}"] = (rng.standard_normal(shape) * scale) \
            .astype(np.float32)
    inputs["moe_cot"] = rng.standard_normal((MOE_T, MOE_D)).astype(
        np.float32)
    for name, shape, scale in (("q", (4, 1, 8, 64), 0.3),
                               ("k", (4, 64, 2, 64), 0.3),
                               ("v", (4, 64, 2, 64), 1.0)):
        inputs[f"cp_{name}"] = (rng.standard_normal(shape) * scale).astype(
            np.float32)
    # a router that sends every token's first choice to expert 0, so the
    # capacity of 5 a shard drops tokens
    inputs["moe_x"] += 0.5
    inputs["moe_wr"][:, 0] += 0.2
    jax_params = {}
    for arch in worker.ARCHS:
        model = JModel(_jax_config(arch))
        jax_params[arch] = (model, jax.jit(model.init_params)(
            jax.random.PRNGKey(0)))
        inputs.update(_flat(jax_params[arch][1], arch))
    np.savez(root / "inputs.npz", **inputs)

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ranks = [subprocess.Popen([sys.executable, str(WORKER), str(r),
                               str(root)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    jax_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_moe = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_MOE),
         str(root / "inputs.npz"), str(root / "jax_moe.npz")], env=jax_env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    tokens = inputs["tokens"]
    jax_fwd = {arch: np.asarray(jax.jit(
        lambda p, t, m=model: m.forward(p, t)[0])(params, tokens))
        for arch, (model, params) in jax_params.items()}
    model, params = jax_params[worker.ODD_ARCH]
    b, n = worker.ODD
    jax_fwd["odd"] = np.asarray(model.forward(params, tokens[:b, :n])[0])
    logs = []
    for proc in ranks + [jax_moe]:
        text, _ = proc.communicate(timeout=TIMEOUT)
        logs.append(text)
    for proc, text in zip(ranks + [jax_moe], logs):
        assert proc.returncode == 0, text[-6000:]
    return {"ours": dict(np.load(root / "results.npz")),
            "jax_moe": dict(np.load(root / "jax_moe.npz")),
            "jax_fwd": jax_fwd, "inputs": inputs}


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_moe_matches_the_reference_sharded_form_with_drops(run):
    """Capacity factor 1.25: each data shard of 8 tokens has capacity 5
    (unsharded it would be 10), so tokens drop; the port follows the
    reference's sharded form, not its unsharded one."""
    ours, ref = run["ours"], run["jax_moe"]
    for i in range(2):
        np.testing.assert_array_equal(ours[f"moe_slots_{i}"],
                                      ref[f"slots_{i}"])
        assert (ours[f"moe_slots_{i}"] < 0).any()      # drops happen
    np.testing.assert_allclose(ours["moe_y_1.25"], ref["y_1.25"], atol=1e-5,
                               rtol=0)
    assert np.abs(ours["moe_y_1.25"] - ours["moe_unsharded_1.25"]).max() \
        > 1e-3                                          # not the unsharded


def test_moe_matches_unsharded_without_drops(run):
    ours, ref = run["ours"], run["jax_moe"]
    np.testing.assert_allclose(ours["moe_y_8.0"], ours["moe_unsharded_8.0"],
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(ours["moe_y_8.0"], ref["y_8.0"], rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_aux_matches_the_reference_sharded_form(run, cf):
    """aux: the mean of each data shard's load-balance loss, as the
    reference's ``moe_ffn_sharded`` gives it."""
    ours, ref = run["ours"], run["jax_moe"]
    np.testing.assert_allclose(ours[f"moe_aux_{cf}"], ref[f"aux_{cf}"],
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(ours[f"moe_aux_{cf}"],
                               ours[f"moe_shard_aux_{cf}"].mean(), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("form", ["split", "whole"])
@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("term", ["y", "aux"])
def test_moe_gradients_match_the_unsharded_form_per_data_shard(run, form, cf,
                                                               term):
    """The gradients of the sharded MoE (tokens split over data, or
    replicated where they do not split) into x, the router and the
    experts, against the unsharded ``moe_ffn`` run on each data shard's
    tokens with the same local capacity: the load-balance term's gradient
    is neither divided over the model ranks nor lost."""
    ours = run["ours"]
    ops = ("x", "wr", "wg", "wu", "wd") if term == "y" else ("x", "wr")
    for op in ops:
        key = f"moe_grad_{form}_{cf}_{term}_{op}"
        want = ours[key + "_plain"]
        assert np.abs(want).max() > 0, key
        assert _rel(ours[key + "_mesh"], want) <= TOL, (key, _rel(
            ours[key + "_mesh"], want))


@pytest.mark.parametrize("arch", list(worker.ARCHS))
def test_model_on_mesh_matches_unsharded_and_jax(run, arch):
    ours, jfwd = run["ours"], run["jax_fwd"][arch]
    placements = json.loads(str(ours[f"{arch}_placements"]))
    assert "Shard(dim=3)" in placements["blocks.wq"]     # over model
    for name in ("plain", "mesh"):
        fwd, dec = ours[f"{arch}_{name}_forward"], ours[f"{arch}_{name}_decode"]
        assert fwd.shape == jfwd.shape
        assert _rel(fwd, jfwd) <= TOL, (name, _rel(fwd, jfwd))
        # the prefill's logits, then each teacher-forced decode step's,
        # against the forward over all the tokens
        assert dec.shape == jfwd.shape
        assert _rel(dec, jfwd) <= TOL, (name, _rel(dec, jfwd))
    for kind in ("forward", "decode"):
        mesh, plain = ours[f"{arch}_mesh_{kind}"], ours[f"{arch}_plain_{kind}"]
        assert _rel(mesh, plain) <= TOL, kind


@pytest.mark.parametrize("arch", list(worker.ARCHS))
def test_init_and_caches_on_mesh_equal_the_unsharded(run, arch):
    """``init_params`` on the mesh, each rank keeping its block of each
    drawn matrix, gives the unsharded init's numbers from the same seed,
    in both threefry modes;
    ``init_decode_caches``, each rank allocating its blocks only, the
    unsharded caches."""
    ours = run["ours"]
    assert json.loads(str(ours[f"{arch}_init_mismatch"])) == []
    assert json.loads(str(ours[f"{arch}_cache_mismatch"])) == []


def test_moe_tokens_that_do_not_split_over_the_data_axes(run):
    """grok-1 over 1 x 35 tokens: the reference's rule sends them to the
    unsharded MoE (capacity from all 35); the port's local map takes them
    replicated over the data axes, with the same capacity."""
    ours, want = run["ours"], run["jax_fwd"]["odd"]
    assert ours["odd_mesh"].shape == want.shape
    assert _rel(ours["odd_mesh"], ours["odd_plain"]) <= TOL
    assert _rel(ours["odd_mesh"], want) <= TOL


@pytest.mark.parametrize("variant", ["attn", "attn-sp"])
def test_variants_move_no_logit(run, variant):
    ours = run["ours"]
    got, base = ours[f"variant_{variant}"], ours["yi-6b_mesh_forward"]
    assert _rel(got, base) <= TOL
    assert _rel(got, run["jax_fwd"]["yi-6b"]) <= TOL


def test_three_adamw_steps_on_mesh(run):
    ours = run["ours"]
    mesh, plain = ours["train_mesh_loss"], ours["train_plain_loss"]
    assert len(mesh) == worker.TRAIN_STEPS
    np.testing.assert_allclose(mesh, plain, rtol=1e-5, atol=0)
    # the clipping norm is the whole gradient's, every shard of it
    np.testing.assert_allclose(ours["train_mesh_grad_norm"],
                               ours["train_plain_grad_norm"], rtol=1e-5)
    assert mesh[-1] <= mesh[0] + 0.5


def test_a_mesh_needs_a_process_group():
    import torch.distributed as dist
    from repro_torch.launch import mesh as meshlib
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        meshlib.make_local_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        meshlib.make_production_mesh(multi_pod=True, device_type="cpu")
    assert not dist.is_initialized()      # nothing started quietly


def _jax_decode(inputs, window, sink, int8, ring, pos):
    from repro.kernels.decode_attention import decode_attention_pallas
    from repro.models import attention as jattn
    q, k, v = (jnp.asarray(inputs[f"cp_{n}"]) for n in ("q", "k", "v"))
    sp = jnp.arange(k.shape[1], dtype=jnp.int32)
    if ring:
        sp = jnp.where(sp < 32, sp, -1)
    kw = dict(window=window, n_sink=sink)
    if int8:
        k, ks = jattn.quantize_kv(k)
        v, vs = jattn.quantize_kv(v)
        kw.update(k_scale=ks, v_scale=vs)
    if pos < 0:     # nothing visible: the Pallas kernel's 0, not jnp's mean
        return np.asarray(decode_attention_pallas(
            q, k, v, sp, jnp.asarray(pos, jnp.int32), block_s=32,
            interpret=True, **kw))
    return np.asarray(jattn.decode_attention(
        q, k, v, sp, jnp.asarray(pos, jnp.int32), **kw))


@pytest.mark.parametrize("case", worker.CP_DECODE, ids=lambda c: c[0])
def test_context_parallel_decode_matches_unsharded_and_jax(run, case):
    name, window, sink, int8, pos = case
    ours = run["ours"]
    got, plain = ours[f"cp_{name}_mesh"], ours[f"cp_{name}_plain"]
    want = _jax_decode(run["inputs"], window, sink, int8, name == "ring",
                       pos)
    assert got.shape == want.shape == (4, 1, 8, 64)
    if pos < 0:
        assert not got.any() and not plain.any() and not want.any()
        return
    assert _rel(got, plain) <= TOL, _rel(got, plain)
    assert _rel(got, want) <= TOL, _rel(got, want)
