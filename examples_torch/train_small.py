"""Train a ~100M-param model for a few hundred steps on the QA corpus with
the PyTorch port (end-to-end training driver).

    PYTHONPATH=src python examples_torch/train_small.py [--steps 300] [--device cpu]

Uses the mamba2-130m architecture at FULL assigned size (130M params),
the synthetic QA corpus, AdamW + cosine schedule, and checkpoints at the
end (``--checkpoint``, by default in the temporary directory).
``--reduced`` takes the small variant (fast CI).
"""
import argparse
import math
import os
import tempfile

from repro_torch.core.types import resolve_device
from repro_torch.launch.train import main as train_main


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced variant (fast CI)")
    ap.add_argument("--checkpoint", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_mamba2_130m.npz"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    resolve_device(args.device)
    # launch.train.main takes its argv (the reference's reads sys.argv)
    train_argv = ["--arch", "mamba2-130m", "--steps", str(args.steps),
                  "--batch", "4", "--seq", "128", "--lr", "1e-3",
                  "--checkpoint", args.checkpoint, "--device", args.device]
    if not args.reduced:
        train_argv.append("--full")
    out = train_main(train_argv)
    losses = out["loss"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"a loss is not finite: {losses}")
    return {"decisions": {"steps": len(losses)},
            "scores": {},
            "counters": {"losses": losses},
            "observed": {"grad_norm": out["grad_norm"], "lr": out["lr"]}}


if __name__ == "__main__":
    main()
