"""The correctness check's two readings, on the card at a cell's own size.

    python3 cachebench/control.py --workload <cell> --seconds <s> \
        --seeds <n1,n2,...>

For each seed, one run of the cell (its rate, a window of ``--seconds``)
whose served answers are judged twice: against the references as a
benchmark run judges them (the program's reading), and with the
reference put in the program's place a precision below the
configuration's (the control's reading): the cache's scores from TF32
operands for its f32 keys, the model's products from float8 e4m3 for its
bf16. Each seed's numbers go to standard error as one JSON line. The
limits in ``cells/<cell>.json`` lie between the largest reading of sound
runs and the smallest reading of the control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    from cachebench import harness
    cell = harness.load_cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run(cell, seed=seed, seconds=args.seconds, trace=False,
                          device=device, t_start=time.perf_counter(),
                          control=True, log=lambda s: None)
        print("readings " + json.dumps({
            "seed": seed, "program": out["checks"],
            "control": out["info"]["control"],
            "reference_s": out["info"]["reference_s"]}), file=sys.stderr,
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
