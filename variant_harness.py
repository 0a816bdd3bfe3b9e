"""Build-and-time harness of the kernel variant scripts
(``flash_variants.py``, ``decode_variants.py``, ``cosine_variants.py``,
``ivf_variants.py``, ``masked_variants.py``).

Each script rebuilds one CUDA source with one choice changed by a text
edit; ``build`` compiles every variant with ``nvcc`` for ``sm_90a``, one
process each, all started together, and ``turns`` times them from CUDA
graphs, in turns, so that a slow drift of the card's clock falls on every
variant alike. Imports nothing at module level beyond the standard library.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
from pathlib import Path
from typing import Callable

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
NVCC = "/usr/local/cuda/bin/nvcc"


def build(sources: dict[str, str], out: Path, required: set[str],
          ptxas: Callable[[str], object]
          ) -> dict[str, tuple[ctypes.CDLL, object]]:
    """Compiles each ``{name: source text}`` into ``out/lib{name}.so``;
    nvcc's ``-Xptxas -v`` log goes to ``out/{name}.log``. A variant that
    does not compile is printed as a JSON line and left out, unless it is
    in ``required``: then the script exits. Returns each library and
    ``ptxas(log)``, the part of the log that the script reports."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
             "-I", str(CSRC), "-o", str(out / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        (out / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            if name in required:
                raise SystemExit(f"nvcc failed on {name}:\n{log[-3000:]}")
            print(json.dumps({"variant": name, "nvcc_failed": log[-1500:]}),
                  flush=True)
            continue
        libs[name] = (ctypes.CDLL(str(out / f"lib{name}.so")), ptxas(log))
    return libs


def turns(fns: dict[str, Callable[[], object]], reps: int
          ) -> dict[str, list[float]]:
    """Each function's device time per call in ms, ``reps`` calls in one
    CUDA graph (``chip_smoke._time_graph``), in four turns, every other
    turn in reverse order. Returns each function's four times."""
    import torch

    import chip_smoke as cs
    times = {name: [] for name in fns}
    for turn in range(4):
        for name in list(fns)[::1 if turn % 2 == 0 else -1]:
            times[name].append(cs._time_graph(torch, fns[name], reps))
    return times


def ptxas_after(marker: Callable[[str], bool]) -> Callable[[str], str]:
    """A ``ptxas`` for ``build``: the two lines (stack and spills,
    registers) after the first ``properties`` line for which ``marker``
    holds, joined by `` | ``; empty if there is none."""
    def pick(log: str) -> str:
        lines = log.splitlines()
        at = [i for i, line in enumerate(lines)
              if "properties" in line and marker(line)]
        return " | ".join(x.strip() for x in lines[at[0] + 1:at[0] + 3]) \
            if at else ""
    return pick
