#!/usr/bin/env python3
"""Times ``launch.train --arch qwen2-vl-2b --full`` of this checkout and of
another (``--parent DIR``, e.g. an unpacked ``git archive`` of the commit
before) on one NVIDIA GPU, in alternating turns (parent, this, this,
parent, parent, this, ...), each turn a process of its own.

    python3 train_turns.py --parent DIR [--turns 6] [--steps 10]
        [--profile N] [--out FILE.jsonl]

Each turn runs ``repro_torch.launch.train.train`` (qwen2-vl-2b at full
width, bf16, batches of 8 x 128 tokens from the driver's own sampler) from
that checkout's ``src`` for ``--steps`` steps, and times every step after
the first (the first builds the kernels) on the host's clock after a
synchronize, as ``chip_smoke.py``'s ``train`` phase does, and reports
over those steps the caching allocator's cudaMalloc / cudaFree calls and
retries and the host time of a call of the flash-attention backward's
wrapper (``flash_attention_bwd_cuda``, no synchronize). With
``--profile N`` each turn runs N steps more under ``torch.profiler`` (CUDA
activity only; these steps are not in the step times) and reports the
card's kernel time a step, its idle share (1 - the union of the kernels'
intervals over those steps' wall time) and the kernels that take the most
time a step. Prints one JSON line a turn, then one a checkout (the median
step over all its turns, each turn's median and their spread) and, last,
the card's name and power limit; the JSON lines also go to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def kernel_summary(prof, wall_s: float, steps: int) -> dict:
    """The profiled steps' kernels: their time a step, the card's idle
    share over ``wall_s`` and the 12 kernels of most time a step (ms)."""
    from torch.autograd import DeviceType
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) \
            + e.time_range.elapsed_us()
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"kernel_ms_per_step": sum(by_name.values()) / steps / 1e3,
            "busy_ms_per_step": busy / steps / 1e3,
            "wall_ms_per_step": wall_s / steps * 1e3,
            "idle_share": 1.0 - busy / 1e6 / wall_s,
            "top_kernels_ms_per_step": {n: t / steps / 1e3 for n, t in top}}


# the caching allocator's counters read over the timed steps: cudaMalloc
# and cudaFree calls (each synchronizes the card) and retries after a
# failed allocation
ALLOC_COUNTERS = ("segment.all.allocated", "segment.all.freed",
                  "num_alloc_retries")


def one(steps: int, profile: int) -> None:
    """One turn, in the checkout on ``PYTHONPATH``: one JSON line."""
    import torch
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.launch import train
    times, prof, stats, bwd_host_s = [], None, [], []
    bwd = kflash.flash_attention_bwd_cuda

    def timed_bwd(*args, **kwargs):   # the backward wrapper's host time
        t0 = time.perf_counter()
        out = bwd(*args, **kwargs)
        if 2 <= len(times) <= steps:
            bwd_host_s.append(time.perf_counter() - t0)
        return out
    kflash.flash_attention_bwd_cuda = timed_bwd

    def log(line):
        nonlocal prof
        torch.cuda.synchronize()
        times.append(time.perf_counter())
        if len(times) in (2, steps + 1):   # the timed steps' ends
            mem = torch.cuda.memory_stats()
            stats.append([mem.get(key, 0) for key in ALLOC_COUNTERS])
        if profile and len(times) == steps + 1:     # the timed steps done
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            times.append(time.perf_counter())
        elif prof is not None and len(times) == steps + profile + 2:
            prof.__exit__(None, None, None)
    out = train.train("qwen2-vl-2b", steps=steps + profile, full=True,
                      log_every=1, log=log, device="cuda")
    step_s = [b - a for a, b in zip(times[1:steps], times[2:steps + 1])]
    row = {"step_s": step_s, "loss": out["loss"][:steps],
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "reserved_bytes": torch.cuda.memory_reserved(),
           "timed_steps_alloc": dict(zip(ALLOC_COUNTERS, (
               b - a for a, b in zip(*stats)))),
           "bwd_calls": len(bwd_host_s),
           "bwd_host_us_median": 1e6 * median(bwd_host_s)
           if bwd_host_s else None}
    if prof is not None:
        row["profile"] = kernel_summary(prof, times[-1] - times[steps + 1],
                                        profile)
    print(json.dumps(row))


def median(xs: list[float]) -> float:
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", type=Path)
    parser.add_argument("--turns", type=int, default=6)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--profile", type=int, default=0)
    parser.add_argument("--out", type=Path,
                        default=ROOT / "build" / "train_turns.jsonl")
    parser.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        return one(args.steps, args.profile)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("train_turns: no CUDA device")
    if args.parent is None or not (args.parent / "src" / "repro_torch").is_dir():
        raise SystemExit("train_turns: --parent DIR must hold src/repro_torch")
    trees = {"parent": args.parent.resolve(), "this": ROOT}
    order = [("parent", "this", "this", "parent")[i % 4]
             for i in range(args.turns)]
    args.out.parent.mkdir(parents=True, exist_ok=True)
    runs = {name: [] for name in trees}
    profiles = {name: [] for name in trees}
    with args.out.open("w") as sink:
        def emit(row: dict) -> None:
            print(json.dumps(row), flush=True)
            sink.write(json.dumps(row) + "\n")
        for turn, name in enumerate(order):
            env = dict(os.environ, PYTHONPATH=str(trees[name] / "src"))
            done = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--one",
                 "--steps", str(args.steps), "--profile", str(args.profile)],
                cwd=trees[name], env=env,
                capture_output=True, text=True)
            if done.returncode != 0:
                sys.stderr.write(done.stderr[-4000:])
                raise SystemExit(f"train_turns: turn {turn} ({name}) failed")
            row = json.loads(done.stdout.strip().splitlines()[-1])
            runs[name].append(row["step_s"])
            if "profile" in row:
                profiles[name].append(row["profile"])
            emit({"turn": turn, "tree": name,
                  "step_s_median": median(row["step_s"]), **row})
        for name, turns in runs.items():
            medians = [median(t) for t in turns]
            summary = {"tree": name, "turns": len(turns),
                       "step_s_median": median([s for t in turns for s in t]),
                       "turn_medians": medians,
                       "spread_s": max(medians) - min(medians)}
            if args.profile:
                summary.update({key: median([p[key] for p in profiles[name]])
                                for key in ("kernel_ms_per_step",
                                            "busy_ms_per_step",
                                            "wall_ms_per_step",
                                            "idle_share")})
            emit(summary)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
