"""The port's benchmark: one run of one cell.

    python3 cachebench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: each number the
correctness check compared, with its limit. The same checks close
standard error. Without CUDA, with fewer cards than the cell asks for, or
with the JAX package or JAX loaded once the window has closed, it prints
no result and exits non-zero.

``--sweep r1,r2,...`` serves one window at each rate in one process, each
on a freshly warmed cache, for finding the knee; the benchmark's runs
never search for a rate.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--sweep", default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("cachebench: no CUDA device", file=sys.stderr)
        return 2
    from cachebench import harness
    cell = harness.load_cell(args.workload)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)
    if torch.cuda.device_count() < chips:
        print(f"cachebench: the cell needs {chips} card(s), "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    log = (lambda s: print(s, file=sys.stderr, flush=True))
    if args.sweep:
        from cachebench import sweep
        sweep.run(cell, [float(r) for r in args.sweep.split(",")],
                  seed=args.seed, seconds=args.seconds, device=device,
                  log=log)
        return 0
    out = harness.run(cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=device,
                      t_start=T_START, log=log)
    found = harness.forbidden_modules()
    if found:
        print(f"cachebench: loaded in this process: {found}",
              file=sys.stderr)
        return 3
    line = result_line(out, cell, bench, trace=bool(args.trace),
                       kind=torch.cuda.get_device_name(device), count=chips)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


def result_line(out: dict, cell, bench: dict, *, trace: bool, kind: str,
                count: int) -> dict:
    """The run's result: each metric as ``{"value", "unit"}`` (the
    end-to-end ones with their units from ``bench``, the per-layer ones
    as their readers gave them), the device, and last each compared
    number beside its limit."""
    limits = cell.cell["limits"]
    checks = {k: {"value": out["checks"][k], "limit": limits[k]}
              for k in limits}
    if trace:
        metrics = out["metrics"]
    else:
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in out["metrics"].items()}
    device_info = {"platform": "gpu", "kind": kind, "count": count,
                   "memory_peak_bytes": out["memory_peak_bytes"]}
    if trace:
        device_info["busy_s"] = out["busy_s"]
        device_info["window_s"] = out["window_s"]
    line = {"correct": all(c["value"] <= c["limit"]
                           for c in checks.values()),
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device_info}
    if trace:
        line["breakdown"] = out["breakdown"]
    line["checks"] = checks
    return line


if __name__ == "__main__":
    sys.exit(main())
