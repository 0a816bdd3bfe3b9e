"""Shape dry run of every (arch x shape) pair on PyTorch's ``meta`` device,
on one card and on the production meshes, and of the sharded
semantic-cache step on a real device (PyTorch port of
``repro.launch.dryrun``).

The reference lowers and compiles every pair for a 512-chip production
mesh on placeholder host devices, without running it. Its counterpart
here runs every pair on the ``meta`` device: each op computes its output's
shape and dtype and allocates nothing, so the full-size models (llama3's
405 B parameters, grok-1's experts) run their whole step (a train step
with its backward and AdamW update, a 32k prefill, a decode step against
32k caches) in seconds on any host. Kernel dispatch follows the device
(``kernels/ops.py``), so meta tensors reach the plain versions in
``kernels/ref.py``; an op that reads a value on the host fails there, and
the pair is recorded as failed, with the op that stopped it.

Each artifact (one JSON file a pair) records parameter, optimizer and
cache bytes (the tensors' ``nbytes``), the analytic FLOP and HBM models
of ``roofline.py`` with ``derive``'s row on one card, the FLOPs that
``torch.utils.flop_counter`` counts over the run (the counterpart of the
reference's raw ``cost_analysis()``) and a histogram of the aten ops it
dispatched (of ``hlo_analysis.op_histogram``), and, where a CUDA device is
present, whether the bytes fit it. Collectives are zero on one card.

``--mesh pod_16x16`` / ``--mesh multipod_2x16x16`` (``--multi-pod``) run
the pairs on a production mesh (``launch/mesh.py``: 256 or 512 ranks) in
a world of the ``fake`` process-group backend; ``--mesh both``
(``--both-meshes``) runs each mesh in a process of its own (a process has
one default group). The process is rank 0 of its world, its
tensors are ``meta`` DTensors, and a collective returns at once. Each step
is built on the mesh with the reference's ``in_shardings`` and
``out_shardings`` as placements: parameters and AdamW moments by
``param_pspecs``/``opt_pspecs``, inputs and caches by ``batch_pspecs`` and
``decode_cache_pspecs``, logits batch-sharded. The artifact then holds
rank 0's bytes (parameters, moments, caches: its shards), the
collectives its step dispatched (``comm_stats.py``, by kind, the
reference's per-chip conventions), its argument and output bytes (the
counterpart of ``memory_analysis``) and the roofline on the mesh. On a
mesh the ``attn`` and ``sp`` variants (attention sharding constraints,
sequence-parallel residuals) are redistributions; without one they are
no-ops, as the reference's ``_constrain`` is. The meshes' CPU device type
makes DTensor turn an all-to-all into an all-gather and a chunk (gloo has
no all-to-all), so a reshard between two shardings counts as an
all-gather.

The cache pair runs one ``DistributedCache.make_lookup_insert()`` step
(four shards on one device, as ``--shards 4`` serves; on a production mesh
as many shards as its data axes hold, 16 or 32, all on the one device) at
the reference's size: capacity 1,048,576, d=384, a batch of 256. It makes
host copies, so it runs on a real device: the card by default, ``--device
cpu`` (with a smaller ``--capacity``) here. On a mesh its roofline terms
are the reference's per-chip ones (each chip's slab of capacity / n_dp
rows) and its collective bytes those of the shards' exchanges.

Unlike the reference this module sets no environment variable when
imported, and it reruns a pair whose artifact exists.

    python -m repro_torch.launch.dryrun --arch mamba2-130m --shape decode_32k
    python -m repro_torch.launch.dryrun --all --device cpu --capacity 4096
    python -m repro_torch.launch.dryrun --both-meshes --all --out /tmp/dr
"""
from __future__ import annotations

import argparse
import collections
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHITECTURES, INPUT_SHAPES, get_arch, get_shape
from repro_torch.core.cache import SemanticCache
from repro_torch.core.distributed import (DistributedCache, _MeshComm,
                                          make_mesh)
from repro_torch.core.types import CacheConfig, resolve_device
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharding as shlib
from repro_torch.launch.comm_stats import KINDS, CollectiveCounter
from repro_torch.launch.roofline import (LINK_BW, PEAK_FLOPS, PEAK_BYTES,
                                         analytic_flops,
                                         analytic_hbm_bytes_per_chip, derive)
from repro_torch.models.model import Model
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_adamw)

ARTIFACT_DIR = str(Path(__file__).resolve().parents[3] / "build" / "dryrun")
MESH = "one_card"
MESHES = {name: multi for multi, name in meshlib.MESH_NAMES.items()}
ADAMW = AdamWConfig()
VARIANTS = ("dots", "noremat", "kvq", "int8", "attn", "sp")
CACHE_SHARDS = 4
CACHE_STEPS = 5             # timed steps after one warm-up
CACHE_CAPACITY, CACHE_BATCH, CACHE_DIM, CACHE_VALUE_LEN = 1_048_576, 256, 384, 64


def _variant_parts(variant: str) -> set[str]:
    parts = {p for p in variant.split("-") if p}
    unknown = parts - set(VARIANTS)
    if unknown:
        raise ValueError(f"variant {variant!r}: unknown {sorted(unknown)}; "
                         f"known: {VARIANTS}")
    return parts


def _meta_inputs(config, shape) -> dict[str, torch.Tensor]:
    return {name: torch.empty(s, dtype=dt, device="meta")
            for name, (s, dt) in shlib.input_specs(config, shape).items()}


def build_fn_and_args(arch_name: str, shape_name: str, variant: str = "",
                      mesh=None):
    """(fn, args) for one (arch, shape) by name: ``build_step``."""
    return build_step(get_arch(arch_name), get_shape(shape_name), variant,
                      mesh=mesh)


def _mesh_kw(mesh) -> dict:
    """``Model``'s mesh arguments for ``mesh`` (none without one)."""
    if mesh is None:
        return {}
    return dict(mesh=mesh, data_axes=meshlib.data_axes_of(mesh),
                model_axes=meshlib.model_axes_of(mesh))


def build_step(config, shape, variant: str = "", mesh=None):
    """(fn, args) for one config and input shape: ``fn(*args)`` runs the
    step on the ``meta`` device, on ``mesh`` where one is given (the
    reference's in and out shardings as placements, module docstring).

    ``train``: ``(params, opt_state, batch) -> (params, opt_state, loss,
    grads)``, ``loss_fn`` with remat, its backward and the AdamW update
    (in place); ``prefill``: ``(batch,) -> (logits, caches)`` with
    ``collect_cache`` and the last position's logits; ``decode``:
    ``(caches, batch) -> (logits, caches)``, one ``decode_step`` against
    caches of ``decode_cache_size``. ``variant``: ``dots`` / ``noremat``
    pick the remat policy (default ``full``), ``kvq`` int8 KV caches,
    ``attn`` / ``sp`` the attention sharding constraints and
    sequence-parallel residuals (no-ops without a mesh)."""
    parts = _variant_parts(variant)
    policy = "dots" if "dots" in parts else (
        "none" if "noremat" in parts else "full")
    kw = _mesh_kw(mesh)
    if mesh is not None:
        kw.update(opt_attn_sharding="attn" in parts,
                  opt_seq_parallel="sp" in parts)
    model = Model(config, device="meta", remat_policy=policy, **kw)
    batch = {n: model.shard_input(t)
             for n, t in _meta_inputs(config, shape).items()}

    def batch_sharded(logits):
        """The reference's logits out-sharding: batch over data (where it
        divides), the rest replicated."""
        if mesh is None:
            return logits
        spec = (model._batch_spec(logits.shape[0]),) \
            + (None,) * (logits.dim() - 1)
        return model._to_spec(logits, spec)

    if shape.kind == "train":
        model.requires_grad_(True)
        params = dict(model.named_parameters())

        def train_step(params, opt_state, batch):
            with model.mesh_context():
                loss = model.loss_fn(batch["tokens"],
                                     prefix_emb=batch.get("prefix_emb"),
                                     remat=True)
                grads = torch.autograd.grad(loss, list(params.values()),
                                            allow_unused=True)
                grads = {n: torch.zeros_like(p) if g is None else g
                         for (n, p), g in zip(params.items(), grads)}
                params, opt_state, _ = adamw_update(ADAMW, params, grads,
                                                    opt_state)
            return params, opt_state, loss.detach(), grads

        return train_step, (params, init_adamw(params), batch)

    if shape.kind == "prefill":
        def prefill(batch):
            with torch.no_grad():
                logits, caches = model.forward(
                    batch["tokens"], prefix_emb=batch.get("prefix_emb"),
                    collect_cache=True, cache_size=shape.seq_len,
                    logits_last_only=True)
                return batch_sharded(logits), caches
        return prefill, (batch,)

    caches = shlib.decode_cache_specs(config, shape, quantized="kvq" in parts,
                                      model=model)

    def decode(caches, batch):
        with torch.no_grad():
            logits, caches = model.decode_step(caches, batch["tokens"])
            return batch_sharded(logits), caches
    return decode, (caches, batch)


class OpCounter(TorchDispatchMode):
    """Counts the aten ops dispatched under it, by name (the counterpart of
    the reference's HLO op histogram); ``last`` is the op dispatched last,
    which names the op that stopped a failed run."""

    def __init__(self):
        super().__init__()
        self.counts: collections.Counter = collections.Counter()
        self.last: str | None = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.last = str(func.overloadpacket.__name__)
        self.counts[self.last] += 1
        return func(*args, **(kwargs or {}))


def _nbytes(obj) -> int:
    """Bytes of every tensor in a (nested) container or dataclass; of a
    DTensor, this rank's shard."""
    if isinstance(obj, DTensor):
        return obj.to_local().nbytes
    if isinstance(obj, torch.Tensor):
        return obj.nbytes
    if isinstance(obj, dict):
        return sum(_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(v) for v in obj)
    if hasattr(obj, "__dataclass_fields__"):
        return sum(_nbytes(getattr(obj, f)) for f in obj.__dataclass_fields__)
    return 0


def _device_memory() -> int | None:
    return torch.cuda.get_device_properties(0).total_memory \
        if torch.cuda.is_available() else None


def _write(art: dict, out_dir: str, tag: str) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(art, f, indent=1)
    return art


def _failed(art: dict, e: Exception, last_op: str | None, tag: str,
            verbose: bool) -> None:
    art["error"] = f"{type(e).__name__}: {e}"
    art["failed_op"] = last_op
    art["traceback"] = traceback.format_exc()[-4000:]
    if verbose:
        print(f"[FAIL] {tag}: {art['error']} (last op: {last_op})")


def mesh_name_of(mesh) -> str:
    """The artifact name of a mesh: ``one_card`` without one."""
    if mesh is None:
        return MESH
    shape = tuple(mesh.shape)
    for multi, name in meshlib.MESH_NAMES.items():
        if shape == (meshlib.MULTIPOD_SHAPE if multi else meshlib.POD_SHAPE):
            return name
    return "mesh_" + "x".join(str(n) for n in shape)


def run_one(arch_name: str, shape_name: str, *, out_dir: str = ARTIFACT_DIR,
            verbose: bool = True, variant: str = "", mesh=None) -> dict:
    """Run one (arch, shape) step on ``meta`` (on ``mesh`` where one is
    given: the fake world must be up) and write its artifact
    (``<arch>_<shape>_<mesh>[__variant].json``); a failure is recorded
    with its error, the op that stopped it and the traceback."""
    mesh_name = mesh_name_of(mesh)
    tag = f"{arch_name}_{shape_name}_{mesh_name}" + (
        f"__{variant}" if variant else "")
    chips = 1 if mesh is None else mesh.size()
    art: dict = {"arch": arch_name, "shape": shape_name, "mesh": mesh_name,
                 "chips": chips, "ok": False, "variant": variant}
    counter, comms = OpCounter(), CollectiveCounter()
    t0 = time.perf_counter()
    try:
        config, shape = get_arch(arch_name), get_shape(shape_name)
        fn, args = build_fn_and_args(arch_name, shape_name, variant, mesh)
        with FlopCounterMode(display=False) as flop_counter, comms, counter:
            out = fn(*args)
        seconds = time.perf_counter() - t0
        dec = shape.kind == "decode"
        train = shape.kind == "train"
        n_mp = 1 if mesh is None else meshlib.axis_size(
            mesh, meshlib.model_axes_of(mesh))
        n_dp = chips // n_mp
        csize = shlib.decode_cache_size(config, shape) if dec else None
        a_flops = analytic_flops(config, shape, cache_size=csize)
        a_bytes = analytic_hbm_bytes_per_chip(
            config, shape, n_dp, n_mp, cache_size=csize,
            kv_bytes=1 if "kvq" in variant else 2)
        param_bytes = _nbytes(args[0]) if train else sum(
            _nbytes(p) for p in Model(config, device="meta",
                                      **_mesh_kw(mesh)).parameters())
        opt_bytes = _nbytes((args[1].m, args[1].v)) if train else 0
        cache_bytes = _nbytes(args[0]) if dec else 0
        total = param_bytes + opt_bytes + cache_bytes
        memory = _device_memory()
        coll = comms.stats() if mesh is not None else {
            "total_bytes": 0.0, "count": 0}
        art.update(
            ok=True, seconds=seconds, param_bytes=param_bytes,
            opt_bytes=opt_bytes, cache_bytes=cache_bytes,
            state_bytes=total, device_memory=memory,
            fits=None if memory is None else total <= memory,
            collectives=coll,
            op_histogram=dict(counter.counts.most_common()),
            counted_flops=float(flop_counter.get_total_flops()),
            flops=a_flops, bytes_accessed=a_bytes * chips,
            active_params=config.active_param_count(),
            total_params=config.param_count())
        if mesh is not None:
            art["n_dp"], art["n_mp"] = n_dp, n_mp
            # the counterpart of memory_analysis: this rank's argument and
            # output bytes (what it holds of each)
            art["memory"] = {
                "argument_size_in_bytes": _nbytes(args)
                + (0 if train else param_bytes),
                "output_size_in_bytes": _nbytes(out)}
        art["roofline"] = derive(
            arch_name, shape_name, shape.kind, mesh_name, chips,
            flops=a_flops, bytes_accessed=a_bytes * chips,
            collective_bytes_per_chip=coll["total_bytes"],
            n_active_params=config.active_param_count(),
            global_batch=shape.global_batch, seq_len=shape.seq_len).row()
        if verbose:
            print(f"[ok] {tag}: {seconds:.1f}s flops {a_flops:.3g} "
                  f"(counted {art['counted_flops']:.3g}) state "
                  f"{total / 1e9:.3g} GB a chip, collectives "
                  f"{coll['total_bytes'] / 1e9:.3g} GB "
                  f"dominant={art['roofline']['dominant']}", flush=True)
    except Exception as e:  # noqa: BLE001 - recorded in the artifact
        art["seconds"] = time.perf_counter() - t0
        _failed(art, e, counter.last, tag, verbose)
    return _write(art, out_dir, tag)


def build_cache_fn(device, *, capacity: int = CACHE_CAPACITY,
                   batch: int = CACHE_BATCH, dim: int = CACHE_DIM,
                   variant: str = "", seed: int = 0,
                   shards: int = CACHE_SHARDS):
    """(fn, args) for one sharded lookup+insert step on ``device``:
    ``DistributedCache.make_lookup_insert()`` over ``shards`` shards of
    one device, a fresh runtime and a batch of unit queries from
    ``seed``; ``int8`` in ``variant`` gives an int8 slab."""
    parts = _variant_parts(variant)
    dev = resolve_device(device)
    cfg = CacheConfig(dim=dim, capacity=capacity, value_len=CACHE_VALUE_LEN,
                      ttl=3600.0, threshold=0.8,
                      key_dtype=torch.int8 if "int8" in parts
                      else torch.float32)
    dc = DistributedCache(SemanticCache(cfg),
                          make_mesh((shards,), ("data",), device=dev))
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((batch, dim), generator=gen, device=dev)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    args = (dc.init(dev), q,
            torch.randint(0, 32_000, (batch, CACHE_VALUE_LEN), generator=gen,
                          device=dev, dtype=torch.int32),
            torch.full((batch,), CACHE_VALUE_LEN, dtype=torch.int32,
                       device=dev),
            torch.arange(batch, dtype=torch.int32, device=dev),
            torch.tensor(1.0, device=dev))
    return dc.make_lookup_insert(), args


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _ExchangeCounter:
    """Bytes of the cache shards' exchanges (``_MeshComm.all_gather``),
    counted for shard 0 as ``comm_stats`` counts an all-gather: its
    result, every shard's value."""

    def __init__(self):
        self.nbytes, self.calls = 0.0, 0

    def __enter__(self):
        self._orig = orig = _MeshComm.all_gather

        def all_gather(comm, value):
            out = orig(comm, value)
            if comm.shard == 0:
                self.calls += 1
                self.nbytes += sum(_nbytes(v) for v in out)
            return out

        _MeshComm.all_gather = all_gather
        return self

    def __exit__(self, *exc):
        _MeshComm.all_gather = self._orig

    def stats(self, steps: int) -> dict:
        """Per step, in ``comm_stats``' keys."""
        n, c = self.nbytes / steps, self.calls / steps
        return {"bytes": {"all-gather": n}, "count": {"all-gather": c},
                "total_bytes": n,
                "static_count": {k: int(c) if k == "all-gather" else 0
                                 for k in KINDS}}


def run_cache(out_dir: str = ARTIFACT_DIR, variant: str = "",
              device="cuda", *, capacity: int = CACHE_CAPACITY,
              batch: int = CACHE_BATCH, steps: int = CACHE_STEPS,
              verbose: bool = True, mesh_name: str = MESH) -> dict:
    """Run the cache pair on ``device``: one warm-up step, then ``steps``
    lookup+insert steps over the slab it fills, each timed on the host
    clock up to a synchronize (the step reads back to the host itself);
    writes the artifact with the median step, the slab's bytes and its
    roofline terms. On one card (``mesh_name`` ``one_card``, 4 shards):
    the lookup's 2·B·N·d FLOPs at ``PEAK_FLOPS`` and the key slab read
    once at ``PEAK_BYTES``. On a production mesh (as many shards as its
    data axes hold, all on the one device): the reference's per-chip
    terms, each chip's slab of capacity / n_dp rows and its share of the
    FLOPs, and the shards' exchanged bytes over ``LINK_BW``."""
    tag = f"semantic-cache_lookup-insert_{mesh_name}" + (
        f"__{variant}" if variant else "")
    mesh_shape = None if mesh_name == MESH else (
        meshlib.MULTIPOD_SHAPE if MESHES[mesh_name] else meshlib.POD_SHAPE)
    chips = 1 if mesh_shape is None else math.prod(mesh_shape)
    shards = CACHE_SHARDS if mesh_shape is None \
        else chips // mesh_shape[-1]
    art: dict = {"arch": "semantic-cache", "shape": "lookup-insert",
                 "mesh": mesh_name, "chips": chips, "shards": shards,
                 "ok": False, "variant": variant, "capacity": capacity,
                 "batch": batch, "dim": CACHE_DIM}
    t0 = time.perf_counter()
    try:
        fn, (runtime, *rest) = build_cache_fn(
            device, capacity=capacity, batch=batch, variant=variant,
            shards=shards)
        dev = runtime.device
        runtime, out = fn(runtime, *rest)           # warm-up: fills B slots
        _sync(dev)
        step_s = []
        with _ExchangeCounter() as exchanges:
            for i in range(steps):
                now = torch.tensor(2.0 + i, device=dev)
                t = time.perf_counter()
                runtime, out = fn(runtime, *rest[:-1], now)
                _sync(dev)
                step_s.append(time.perf_counter() - t)
        hits = int(out[2].sum())
        slab = sum(r.state.keys.nbytes for r in runtime.shards)
        if mesh_shape is None:
            coll = {"total_bytes": 0.0, "count": 0}
            terms = {"compute_s": 2.0 * batch * capacity * CACHE_DIM
                     / PEAK_FLOPS,
                     "memory_s": slab / PEAK_BYTES, "collective_s": 0.0}
        else:
            coll = exchanges.stats(steps)
            key_bytes = 1 if "int8" in variant else 4
            local = capacity // shards
            terms = {"compute_s": 2.0 * batch * local * CACHE_DIM
                     / PEAK_FLOPS,
                     "memory_s": local * CACHE_DIM * key_bytes / PEAK_BYTES,
                     "collective_s": coll["total_bytes"] / LINK_BW}
        terms["dominant"] = max(("compute", "memory", "collective"),
                                key=lambda k: terms[k + "_s"])
        step_s.sort()
        art.update(
            ok=True, seconds=time.perf_counter() - t0,
            device=str(dev), device_name=torch.cuda.get_device_name(dev)
            if dev.type == "cuda" else "cpu",
            step_ms=1e3 * step_s[len(step_s) // 2], step_ms_all=[
                1e3 * s for s in step_s],
            slab_bytes=slab, state_bytes=_nbytes(runtime),
            hits_last_step=hits, entries=sum(int(r.state.valid.sum())
                                             for r in runtime.shards),
            collectives=coll, roofline=terms)
        if verbose:
            print(f"[ok] {tag}: step {art['step_ms']:.3f} ms on {dev}, slab "
                  f"{slab / 1e9:.3g} GB over {shards} shards, bound "
                  f"{1e3 * max(terms['compute_s'], terms['memory_s']):.3f} ms"
                  f" a chip ({terms['dominant']})", flush=True)
    except Exception as e:  # noqa: BLE001 - recorded in the artifact
        art["seconds"] = time.perf_counter() - t0
        _failed(art, e, None, tag, verbose)
    return _write(art, out_dir, tag)


def _pairs(args) -> list[tuple[str, str]]:
    if args.all:
        return [(a, s) for a in ARCHITECTURES for s in INPUT_SHAPES]
    if not args.arch:
        return []
    archs = list(ARCHITECTURES) if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape in (None, "all") \
        else [args.shape]
    return [(a, s) for a in archs for s in shapes]


def run_mesh(multi_pod: bool, pairs, out_dir: str, variant: str = "",
             verbose: bool = True) -> list[dict]:
    """Run ``pairs`` on a production mesh in this process, which becomes
    rank 0 of a fake world of the mesh's size (once a process)."""
    shape = meshlib.MULTIPOD_SHAPE if multi_pod else meshlib.POD_SHAPE
    meshlib.fake_world(math.prod(shape))
    mesh = meshlib.make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
    return [run_one(a, s, out_dir=out_dir, verbose=verbose,
                    variant=variant, mesh=mesh) for a, s in pairs]


def _mesh_processes(args, pairs) -> list[dict]:
    """The model pairs on both production meshes at once, each in a
    process of its own (``--mesh <name>``, rank 0 of that mesh's fake
    world: a process has one default group); their artifacts."""
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    which = ["--arch", "all"] if args.all else ["--arch", args.arch] + (
        ["--shape", args.shape] if args.shape else [])
    tags = {m: [f"{arch}_{shape}_{m}" + (f"__{args.variant}"
                                         if args.variant else "")
                for arch, shape in pairs] for m in MESHES}
    for tag in sum(tags.values(), []):   # no stale artifact is read
        Path(args.out, tag + ".json").unlink(missing_ok=True)
    procs = {m: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", m,
         *which, "--variant", args.variant, "--out", args.out], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for m in MESHES}
    results = []
    for m, proc in procs.items():
        out, _ = proc.communicate()
        print(out, end="")
        for tag in tags[m]:
            path = Path(args.out, tag + ".json")
            results.append(json.loads(path.read_text()) if path.exists()
                           else {"ok": False, "mesh": m, "tag": tag})
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="architecture id (or all)")
    ap.add_argument("--shape", default=None, help="input shape id (or all)")
    ap.add_argument("--all", action="store_true",
                    help="all 10 archs x 4 shapes, and the cache pair")
    ap.add_argument("--cache", action="store_true",
                    help="run the sharded semantic-cache step")
    ap.add_argument("--mesh", default=MESH,
                    choices=[MESH, *MESHES, "both"],
                    help="one card (default), a production mesh, or both")
    ap.add_argument("--multi-pod", dest="mesh", action="store_const",
                    const=meshlib.MESH_NAMES[True],
                    help="--mesh multipod_2x16x16 (512 ranks)")
    ap.add_argument("--both-meshes", dest="mesh", action="store_const",
                    const="both", help="--mesh both (256 and 512 ranks)")
    ap.add_argument("--variant", default="",
                    help=f"'-'-joined of {VARIANTS}")
    ap.add_argument("--device", default="cuda",
                    help="device of the cache pair (the model pairs run on "
                         "meta)")
    ap.add_argument("--capacity", type=int, default=CACHE_CAPACITY,
                    help="slab slots of the cache pair")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    args = ap.parse_args(argv)
    pairs = _pairs(args)
    meshes = list(MESHES) if args.mesh == "both" else [args.mesh]

    # the cache pairs first, with the host to themselves (they are timed)
    results = [run_cache(args.out, args.variant, args.device,
                         capacity=args.capacity, mesh_name=m)
               for m in meshes if args.cache or args.all]
    if args.mesh == "both":
        results += _mesh_processes(args, pairs)
    elif args.mesh == MESH:
        results += [run_one(arch, shape, out_dir=args.out,
                            variant=args.variant) for arch, shape in pairs]
    elif pairs:
        results += run_mesh(MESHES[args.mesh], pairs, args.out, args.variant)
    n_ok = sum(r.get("ok", False) for r in results)
    for m in meshes:
        sized = [r for r in results if r.get("fits") is not None
                 and r.get("mesh") == m]
        if sized:
            print(f"state a chip (parameters, moments, caches) fits the "
                  f"card's {sized[0]['device_memory'] / 1e9:.1f} GB in "
                  f"{sum(r['fits'] for r in sized)}/{len(sized)} pairs on "
                  f"{m}")
    print(f"\n{n_ok}/{len(results)} dry-runs succeeded")
    if n_ok < len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
