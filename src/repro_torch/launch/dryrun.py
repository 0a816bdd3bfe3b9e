"""Shape dry run of every (arch x shape) pair on PyTorch's ``meta`` device,
and of the sharded semantic-cache step on a real one (PyTorch port of
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

The cache pair runs one ``DistributedCache.make_lookup_insert()`` step
(four shards on one device, as ``--shards 4`` serves) at the reference's
size: capacity 1,048,576, d=384, a batch of 256. It makes host copies, so
it runs on a real device: the card by default, ``--device cpu`` (with a
smaller ``--capacity``) here.

Unlike the reference this module sets no environment variable when
imported, and it reruns a pair whose artifact exists. The reference's
``attn`` and ``sp`` variants are XLA sharding constraints and are refused.

    python -m repro_torch.launch.dryrun --arch mamba2-130m --shape decode_32k
    python -m repro_torch.launch.dryrun --all --device cpu --capacity 4096
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import time
import traceback
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHITECTURES, INPUT_SHAPES, get_arch, get_shape
from repro_torch.core.cache import SemanticCache
from repro_torch.core.distributed import DistributedCache, make_mesh
from repro_torch.core.types import CacheConfig, resolve_device
from repro_torch.launch import sharding as shlib
from repro_torch.launch.roofline import (PEAK_FLOPS, PEAK_BYTES,
                                         analytic_flops,
                                         analytic_hbm_bytes_per_chip, derive)
from repro_torch.models.model import Model
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_adamw)

ARTIFACT_DIR = str(Path(__file__).resolve().parents[3] / "build" / "dryrun")
MESH = "one_card"
ADAMW = AdamWConfig()
VARIANTS = ("dots", "noremat", "kvq", "int8")
XLA_ONLY = ("attn", "sp")   # sharding constraints: no one-card counterpart
CACHE_SHARDS = 4
CACHE_STEPS = 5             # timed steps after one warm-up
CACHE_CAPACITY, CACHE_BATCH, CACHE_DIM, CACHE_VALUE_LEN = 1_048_576, 256, 384, 64


def _variant_parts(variant: str) -> set[str]:
    parts = {p for p in variant.split("-") if p}
    refused = parts & set(XLA_ONLY)
    if refused:
        raise ValueError(
            f"variant {variant!r}: {sorted(refused)} are XLA sharding "
            "constraints of the reference's production mesh and have no "
            "counterpart on one card")
    unknown = parts - set(VARIANTS)
    if unknown:
        raise ValueError(f"variant {variant!r}: unknown {sorted(unknown)}; "
                         f"known: {VARIANTS}")
    return parts


def _meta_inputs(config, shape) -> dict[str, torch.Tensor]:
    return {name: torch.empty(s, dtype=dt, device="meta")
            for name, (s, dt) in shlib.input_specs(config, shape).items()}


def build_fn_and_args(arch_name: str, shape_name: str, variant: str = ""):
    """(fn, args) for one (arch, shape) by name: ``build_step``."""
    return build_step(get_arch(arch_name), get_shape(shape_name), variant)


def build_step(config, shape, variant: str = ""):
    """(fn, args) for one config and input shape: ``fn(*args)`` runs the
    step on the ``meta`` device.

    ``train``: ``(params, opt_state, batch) -> (params, opt_state, loss,
    grads)``, ``loss_fn`` with remat, its backward and the AdamW update
    (in place); ``prefill``: ``(batch,) -> (logits, caches)`` with
    ``collect_cache`` and the last position's logits; ``decode``:
    ``(caches, batch) -> (logits, caches)``, one ``decode_step`` against
    caches of ``decode_cache_size``. ``variant``: ``dots`` / ``noremat``
    pick the remat policy (default ``full``), ``kvq`` int8 KV caches."""
    parts = _variant_parts(variant)
    policy = "dots" if "dots" in parts else (
        "none" if "noremat" in parts else "full")
    model = Model(config, device="meta", remat_policy=policy)
    batch = _meta_inputs(config, shape)

    if shape.kind == "train":
        model.requires_grad_(True)
        params = dict(model.named_parameters())

        def train_step(params, opt_state, batch):
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
                return model.forward(batch["tokens"],
                                     prefix_emb=batch.get("prefix_emb"),
                                     collect_cache=True,
                                     cache_size=shape.seq_len,
                                     logits_last_only=True)
        return prefill, (batch,)

    caches = shlib.decode_cache_specs(config, shape, quantized="kvq" in parts)

    def decode(caches, batch):
        with torch.no_grad():
            return model.decode_step(caches, batch["tokens"])
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
    """Bytes of every tensor in a (nested) container or dataclass."""
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


def run_one(arch_name: str, shape_name: str, *, out_dir: str = ARTIFACT_DIR,
            verbose: bool = True, variant: str = "") -> dict:
    """Run one (arch, shape) step on ``meta`` and write its artifact
    (``<arch>_<shape>_one_card[__variant].json``); a failure is recorded
    with its error, the op that stopped it and the traceback."""
    tag = f"{arch_name}_{shape_name}_{MESH}" + (f"__{variant}" if variant
                                                 else "")
    art: dict = {"arch": arch_name, "shape": shape_name, "mesh": MESH,
                 "chips": 1, "ok": False, "variant": variant}
    counter = OpCounter()
    t0 = time.perf_counter()
    try:
        config, shape = get_arch(arch_name), get_shape(shape_name)
        fn, args = build_fn_and_args(arch_name, shape_name, variant)
        with FlopCounterMode(display=False) as flop_counter, counter:
            fn(*args)
        seconds = time.perf_counter() - t0
        dec = shape.kind == "decode"
        csize = shlib.decode_cache_size(config, shape) if dec else None
        a_flops = analytic_flops(config, shape, cache_size=csize)
        a_bytes = analytic_hbm_bytes_per_chip(
            config, shape, 1, 1, cache_size=csize,
            kv_bytes=1 if "kvq" in variant else 2)
        param_bytes = sum(p.nbytes for p in
                          Model(config, device="meta").parameters())
        opt_bytes = _nbytes((args[1].m, args[1].v)) \
            if shape.kind == "train" else 0
        cache_bytes = _nbytes(args[0]) if dec else 0
        total = param_bytes + opt_bytes + cache_bytes
        memory = _device_memory()
        art.update(
            ok=True, seconds=seconds, param_bytes=param_bytes,
            opt_bytes=opt_bytes, cache_bytes=cache_bytes,
            state_bytes=total, device_memory=memory,
            fits=None if memory is None else total <= memory,
            collectives={"total_bytes": 0.0, "count": 0},
            op_histogram=dict(counter.counts.most_common()),
            counted_flops=float(flop_counter.get_total_flops()),
            flops=a_flops, bytes_accessed=a_bytes,
            active_params=config.active_param_count(),
            total_params=config.param_count())
        art["roofline"] = derive(
            arch_name, shape_name, shape.kind, MESH, 1, flops=a_flops,
            bytes_accessed=a_bytes, collective_bytes_per_chip=0.0,
            n_active_params=config.active_param_count(),
            global_batch=shape.global_batch, seq_len=shape.seq_len).row()
        if verbose:
            print(f"[ok] {tag}: {seconds:.1f}s flops {a_flops:.3g} "
                  f"(counted {art['counted_flops']:.3g}) state "
                  f"{total / 1e9:.3g} GB "
                  f"dominant={art['roofline']['dominant']}")
    except Exception as e:  # noqa: BLE001 - recorded in the artifact
        art["seconds"] = time.perf_counter() - t0
        _failed(art, e, counter.last, tag, verbose)
    return _write(art, out_dir, tag)


def build_cache_fn(device, *, capacity: int = CACHE_CAPACITY,
                   batch: int = CACHE_BATCH, dim: int = CACHE_DIM,
                   variant: str = "", seed: int = 0):
    """(fn, args) for one sharded lookup+insert step on ``device``:
    ``DistributedCache.make_lookup_insert()`` over ``CACHE_SHARDS`` shards
    of one device, a fresh runtime and a batch of unit queries from
    ``seed``; ``int8`` in ``variant`` gives an int8 slab."""
    parts = _variant_parts(variant)
    dev = resolve_device(device)
    cfg = CacheConfig(dim=dim, capacity=capacity, value_len=CACHE_VALUE_LEN,
                      ttl=3600.0, threshold=0.8,
                      key_dtype=torch.int8 if "int8" in parts
                      else torch.float32)
    dc = DistributedCache(SemanticCache(cfg),
                          make_mesh((CACHE_SHARDS,), ("data",), device=dev))
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


def run_cache(out_dir: str = ARTIFACT_DIR, variant: str = "",
              device="cuda", *, capacity: int = CACHE_CAPACITY,
              batch: int = CACHE_BATCH, steps: int = CACHE_STEPS,
              verbose: bool = True) -> dict:
    """Run the cache pair on ``device``: one warm-up step, then ``steps``
    lookup+insert steps over the slab it fills, each timed on the host
    clock up to a synchronize (the step reads back to the host itself);
    writes the artifact with the median step, the slab's bytes and its
    roofline terms (the lookup's 2·B·N·d FLOPs at ``PEAK_FLOPS``, the key
    slab read once at ``PEAK_BYTES``)."""
    tag = f"semantic-cache_lookup-insert_{MESH}" + (f"__{variant}" if variant
                                                    else "")
    art: dict = {"arch": "semantic-cache", "shape": "lookup-insert",
                 "mesh": MESH, "chips": 1, "shards": CACHE_SHARDS,
                 "ok": False, "variant": variant, "capacity": capacity,
                 "batch": batch, "dim": CACHE_DIM}
    t0 = time.perf_counter()
    try:
        fn, (runtime, *rest) = build_cache_fn(
            device, capacity=capacity, batch=batch, variant=variant)
        dev = runtime.state.keys.device
        runtime, out = fn(runtime, *rest)           # warm-up: fills B slots
        _sync(dev)
        step_s = []
        for i in range(steps):
            now = torch.tensor(2.0 + i, device=dev)
            t = time.perf_counter()
            runtime, out = fn(runtime, *rest[:-1], now)
            _sync(dev)
            step_s.append(time.perf_counter() - t)
        hits = int(out[2].sum())
        slab = runtime.state.keys.nbytes
        terms = {"compute_s": 2.0 * batch * capacity * CACHE_DIM / PEAK_FLOPS,
                 "memory_s": slab / PEAK_BYTES, "collective_s": 0.0}
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
            hits_last_step=hits, entries=int(runtime.state.valid.sum()),
            collectives={"total_bytes": 0.0, "count": 0}, roofline=terms)
        if verbose:
            print(f"[ok] {tag}: step {art['step_ms']:.3f} ms on {dev}, slab "
                  f"{slab / 1e9:.3g} GB, bound "
                  f"{1e3 * max(terms['compute_s'], terms['memory_s']):.3f} ms"
                  f" ({terms['dominant']})")
    except Exception as e:  # noqa: BLE001 - recorded in the artifact
        art["seconds"] = time.perf_counter() - t0
        _failed(art, e, None, tag, verbose)
    return _write(art, out_dir, tag)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="architecture id (or all)")
    ap.add_argument("--shape", default=None, help="input shape id (or all)")
    ap.add_argument("--all", action="store_true",
                    help="all 10 archs x 4 shapes, and the cache pair")
    ap.add_argument("--cache", action="store_true",
                    help="run the sharded semantic-cache step")
    ap.add_argument("--variant", default="",
                    help=f"'-'-joined of {VARIANTS}")
    ap.add_argument("--device", default="cuda",
                    help="device of the cache pair (the model pairs run on "
                         "meta)")
    ap.add_argument("--capacity", type=int, default=CACHE_CAPACITY,
                    help="slab slots of the cache pair")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    args = ap.parse_args(argv)

    results = []
    if args.cache or args.all:
        results.append(run_cache(args.out, args.variant, args.device,
                                 capacity=args.capacity))
    if args.all:
        for arch in ARCHITECTURES:
            for shape in INPUT_SHAPES:
                results.append(run_one(arch, shape, out_dir=args.out))
    elif args.arch:
        archs = list(ARCHITECTURES) if args.arch == "all" else [args.arch]
        shapes = list(INPUT_SHAPES) if args.shape in (None, "all") \
            else [args.shape]
        for arch in archs:
            for shape in shapes:
                results.append(run_one(arch, shape, out_dir=args.out,
                                       variant=args.variant))
    n_ok = sum(r.get("ok", False) for r in results)
    sized = [r for r in results if r.get("fits") is not None]
    if sized:
        print(f"state (parameters, moments, caches) fits the card's "
              f"{sized[0]['device_memory'] / 1e9:.1f} GB in "
              f"{sum(r['fits'] for r in sized)}/{len(sized)} pairs")
    print(f"\n{n_ok}/{len(results)} dry-runs succeeded")
    if n_ok < len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
