#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one H100 and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:
  card      the card's name and power limit; f32 products must not use TF32
  build     nvcc of every kernel source for sm_90a, with -Xptxas -v
  kernel    each CUDA kernel against its plain PyTorch version on the card
  main      the paper's serve loop (``repro_torch.launch.serve`` defaults)
            on the card for f32 and int8 slabs, with the kernel's launches
            counted, held request by request against the same run on the CPU;
            then the separate lookup+insert path against the fused one
  timing    each kernel, its plain version and one PyTorch call computing
            the same function, timed in turns with CUDA events
The last three lines are the card's name and power limit as nvidia-smi
gives them, the per-kernel summary, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
SCORE_TOL = {"f32": 1e-5, "int8": 1e-5, "bf16": 1e-2}
MAIN_BATCHES = 16          # 2,000 test queries in batches of 128


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------- #
def phase_card(torch) -> str:
    card = nvidia_smi()
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        fail("torch.backends.cuda.matmul.allow_tf32 is not False")
    if torch.get_float32_matmul_precision() != "highest":
        fail("float32 matmul precision is not 'highest'")
    emit("card", nvidia_smi=card, torch_name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    return card


def phase_build() -> None:
    from repro_torch.kernels import build
    infos = build.build(force=True)
    for name, info in infos.items():
        entries = []
        for line in info.log.splitlines():
            m = re.search(r"entry function '([^']+)'", line)
            if m:
                entries.append({"function": m.group(1)})
            elif entries and ("Used" in line or "spill" in line):
                entries[-1].setdefault("ptxas", []).append(line.strip())
        emit("build", kernel=name, seconds=info.seconds, library=str(
            info.path.relative_to(ROOT)), entries=entries)


# --------------------------------------------------------------------- #
def _make_keys(torch, gen, n, d, dtype):
    keys = torch.randn((n, d), generator=gen, device="cuda")
    keys = keys / keys.norm(dim=1, keepdim=True)
    if dtype == "bf16":
        return keys.to(torch.bfloat16)
    if dtype == "int8":
        return torch.clamp(torch.round(keys * 127.0), -127, 127).to(torch.int8)
    return keys


def _as_f32(torch, keys):
    return keys.float() / 127.0 if keys.dtype == torch.int8 else keys.float()


def _kernel_case(torch, dtype, b, n, d, k, mask, seed):
    """One comparison of the kernel with its plain version. Returns the max
    abs score error over the finite entries."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.cosine_topk import cosine_topk_cuda
    gen = torch.Generator(device="cuda").manual_seed(seed)
    keys = _make_keys(torch, gen, n, d, dtype)
    # planted exact ties: three equal copies of one key row, at slots
    # t0 < t1 < t2, and the first query rows are that row itself
    t0, t1, t2 = n // 5, n // 2, n - 1
    keys[t1] = keys[t0]
    keys[t2] = keys[t0]
    q = torch.randn((b, d), generator=gen, device="cuda")
    n_tie_rows = min(b, 3)
    q[:n_tie_rows] = _as_f32(torch, keys[t0])
    q = q / q.norm(dim=1, keepdim=True)
    ties = torch.tensor([t0, t1, t2], device="cuda")
    if mask == "all":
        valid = torch.ones(n, dtype=torch.bool, device="cuda")
    elif mask == "none":
        valid = torch.zeros(n, dtype=torch.bool, device="cuda")
    elif mask == "few":
        # k - 1 visible slots: the three ties and k - 4 others
        valid = torch.zeros(n, dtype=torch.bool, device="cuda")
        others = torch.randperm(n, generator=gen, device="cuda")[:k + 3]
        valid[others[~torch.isin(others, ties)][:k - 4]] = True
    else:
        valid = torch.rand(n, generator=gen, device="cuda") < 0.7
    if mask != "none":
        valid[ties] = True
    ks, ki = cosine_topk_cuda(q, keys, valid, k)
    # one entry more than the kernel's, for the gap past its last entry
    rs1, ri1 = ref.cosine_topk_ref(q, keys, valid, k + 1)
    torch.cuda.synchronize()
    ks, ki, rs1, ri1 = (x.cpu() for x in (ks, ki, rs1, ri1))
    rs, ri = rs1[:, :k], ri1[:, :k]
    tol = SCORE_TOL[dtype]
    where = f"{dtype} B={b} N={n} d={d} k={k} mask={mask}"
    if ks.shape != (b, k) or ki.shape != (b, k):
        fail(f"kernel output shape {tuple(ks.shape)} at {where}")
    empty = ri < 0
    if not torch.equal(empty, ki < 0):
        fail(f"empty slots differ at {where}")
    if not bool(torch.all(torch.isneginf(ks[empty]))):
        fail(f"empty slots without -inf at {where}")
    err = (ks[~empty] - rs[~empty]).abs().max().item() if (~empty).any() \
        else 0.0
    if not err <= tol:
        fail(f"scores differ by {err} > {tol} at {where}")
    # ids must agree wherever the score is apart from both neighbours
    # (including the next entry past the list) by more than the tolerance
    gap = torch.full((b, k + 1), math.inf)
    diff = (rs1[:, 1:] - rs1[:, :-1]).abs()
    gap[:, 1:] = torch.minimum(gap[:, 1:], diff)
    gap[:, :-1] = torch.minimum(gap[:, :-1], diff)
    apart = (gap[:, :k] > tol) & ~empty
    if not torch.equal(ki[apart], ri[apart]):
        fail(f"slot ids differ at {where}")
    if mask != "none":
        tie = torch.tensor([t0, t1, t2][:k], dtype=torch.int32)
        for r in range(n_tie_rows):
            if not (torch.equal(ki[r, :len(tie)], tie)
                    and torch.equal(ri[r, :len(tie)], tie)):
                fail(f"planted ties not resolved to the lowest slot at "
                     f"{where}: kernel {ki[r].tolist()}, plain "
                     f"{ri[r].tolist()}")
    return err


def phase_kernel(torch) -> float:
    cases = [  # (B, N, d, k, mask)
        (128, 16384, 384, 4, "all"),
        (128, 16384, 384, 4, "random"),
        (1, 1000, 384, 1, "random"),
        (7, 16383, 1536, 8, "random"),
        (200, 16383, 384, 8, "all"),
        (128, 1000, 384, 4, "none"),
        (7, 1000, 1536, 8, "few"),
        (200, 1048576, 384, 4, "random"),
    ]
    worst = 0.0
    for dtype in ("f32", "bf16", "int8"):
        errs = []
        for i, (b, n, d, k, mask) in enumerate(cases):
            errs.append(_kernel_case(torch, dtype, b, n, d, k, mask,
                                     seed=1000 + i))
        emit("kernel", kernel="cosine_topk", dtype=dtype, cases=len(cases),
             max_abs_err=max(errs), tolerance=SCORE_TOL[dtype])
        worst = max(worst, max(errs))
    return worst


# --------------------------------------------------------------------- #
def _serve(torch, **kw):
    from repro_torch.kernels import cosine_topk as kmod
    from repro_torch.launch import serve
    kmod.launches = 0
    t0 = time.perf_counter()
    engine, requests, responses = serve.run(log=lambda *a: None, **kw)
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return engine, requests, responses, kmod.launches, wall


def _same_decisions(a, b, where: str, tol: float) -> None:
    if len(a) != len(b):
        fail(f"{where}: {len(a)} vs {len(b)} responses")
    for i, (x, y) in enumerate(zip(a, b)):
        if x.cached != y.cached or x.answer != y.answer:
            fail(f"{where}: request {i} differs: {x} vs {y}")
        if not abs(x.score - y.score) <= tol:
            fail(f"{where}: request {i} score {x.score} vs {y.score}")


def phase_main(torch) -> int:
    main_launches = None
    for key_dtype in ("f32", "int8"):
        eng, reqs, resp, launches, wall = _serve(torch, device="cuda",
                                                 key_dtype=key_dtype)
        if launches != MAIN_BATCHES:
            fail(f"main path ({key_dtype}) launched the kernel {launches} "
                 f"times for {MAIN_BATCHES} batches")
        if key_dtype == "f32":
            main_launches = launches
        scores = [r.score for r in resp]
        if len(resp) != len(reqs) or not all(
                math.isfinite(s) for s in scores):
            fail(f"main path ({key_dtype}): missing or non-finite scores")
        cpu, _, cpu_resp, cpu_launches, cpu_wall = _serve(
            torch, device="cpu", key_dtype=key_dtype)
        if cpu_launches != 0:
            fail("the CPU run launched the CUDA kernel")
        _same_decisions(resp, cpu_resp, f"main {key_dtype} cuda vs cpu", 1e-5)
        cats = eng.metrics.summary()["categories"]
        if cats != cpu.metrics.summary()["categories"]:
            fail(f"main {key_dtype}: per-category summary differs from CPU")
        gap = min(abs(s - 0.8) for s in scores)
        # host share of the serve path: embedding the served queries alone
        t0 = time.perf_counter()
        eng.embedder.embed_batch([r.query for r in reqs])
        embed_s = time.perf_counter() - t0
        emit("main", key_dtype=key_dtype, device="cuda", requests=len(resp),
             batches=MAIN_BATCHES, kernel_launches=launches,
             wall_s=wall, wall_per_batch_s=wall / MAIN_BATCHES,
             serve_path_s=eng.metrics.cache_path_time_s,
             embed_queries_s=embed_s,
             cpu_wall_s=cpu_wall, closest_score_to_threshold=gap,
             table1={c: {"hits": m["cache_hits"], "lookups": m["lookups"],
                         "hit_rate": m["hit_rate"],
                         "positive_rate": m["positive_rate"]}
                     for c, m in cats.items()})
    quick = dict(corpus=400, queries=100, device="cuda")
    _, _, fused, fl, _ = _serve(torch, fused=True, **quick)
    _, _, sep, sl, _ = _serve(torch, fused=False, **quick)
    _same_decisions(fused, sep, "separate vs fused", 1e-6)
    if fl != 4 or sl != 4:
        fail(f"quick config launched {fl} (fused) / {sl} (separate) times "
             "for 4 batches")
    emit("main", check="separate path equals fused", requests=len(fused),
         launches_fused=fl, launches_separate=sl)
    return main_launches


# --------------------------------------------------------------------- #
def _time(torch, fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_timing(torch, card: str) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.cosine_topk import cosine_topk_cuda
    out = {}
    b, d, k = 128, 384, 4
    for n, dtype in ((16384, "f32"), (16384, "int8"),
                     (1048576, "f32"), (1048576, "int8")):
        gen = torch.Generator(device="cuda").manual_seed(7)
        keys = _make_keys(torch, gen, n, d, dtype)
        q = torch.randn((b, d), generator=gen, device="cuda")
        q = q / q.norm(dim=1, keepdim=True)
        valid = torch.rand(n, generator=gen, device="cuda") < 0.9
        neg = torch.tensor(float("-inf"), device="cuda")

        def kernel():
            return cosine_topk_cuda(q, keys, valid, k)

        def plain():
            return ref.cosine_topk_ref(q, keys, valid, k)

        def library():
            return torch.topk(torch.where(valid, q @ _as_f32(torch, keys).T,
                                          neg), k)

        reps = 200 if n <= 16384 else 10
        fns = {"kernel": kernel, "plain": plain, "library": library}
        times = {name: [] for name in fns}
        for name in ("kernel", "plain", "library", "library", "plain",
                     "kernel"):
            times[name].append(_time(torch, fns[name], reps))
        ms = {name: sorted(v)[0] for name, v in times.items()}
        flops = 2.0 * b * n * d
        nbytes = b * d * 4 + n * d * keys.element_size() + n + b * k * 8
        t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
        bound_ms = 1e3 * max(t_ops, t_bytes)
        row = {"kernel_ms": ms["kernel"], "plain_ms": ms["plain"],
               "library_ms": ms["library"], "runs_ms": times,
               "bound_ms": bound_ms,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "share_of_bound": bound_ms / ms["kernel"],
               "l2_warm": n * d * keys.element_size() < 50e6}
        out[(n, dtype)] = row
        emit("timing", kernel="cosine_topk", B=b, N=n, d=d, k=k,
             key_dtype=dtype, card=card, **row)
    return out


# --------------------------------------------------------------------- #
def main() -> None:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, str(SRC))

    card = phase_card(torch)
    phase_build()
    max_err = phase_kernel(torch)
    launches = phase_main(torch)
    timing = phase_timing(torch, card)
    for mod in ("jax", "repro"):
        if mod in sys.modules:
            fail(f"{mod} was imported")

    main_row = timing[(16384, "f32")]
    summary = {"kernels": [{
        "name": "cosine_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cosine_topk.cu",
        "replaces": "src/repro/kernels/cosine_topk.py:218",
        "launches": launches, "max_abs_err": max_err,
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]}
    print(nvidia_smi())
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
