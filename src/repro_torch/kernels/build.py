"""Builds the port's CUDA sources at first use and loads them with ctypes.

Each source under ``csrc/`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``).
A library's file name carries a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and an
unchanged one is reused. Sources build in
parallel: one ``nvcc`` each, all started together.

Nothing here runs at import time; this machine-independent module is
imported by the CPU tests, which never build anything.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = {"cosine_topk": "cosine_topk.cu", "ivf_topk": "ivf_topk.cu",
           "flash_attention": "flash_attention.cu",
           "decode_attention": "decode_attention.cu",
           "threefry": "threefry.cu"}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_count_lock = threading.Lock()


def count_launch(launches: dict[str, int], name: str) -> None:
    """Add one to a wrapper's launch counter. The shards of a
    ``DistributedCache`` launch from several threads at once, and a bare
    ``+= 1`` on a dict entry may lose a count between its read and its
    write."""
    with _count_lock:
        launches[name] += 1


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    """One built library: its path, the seconds ``nvcc`` took (0 when an
    existing build was reused) and the compiler's ``-Xptxas -v`` report."""

    name: str
    path: Path
    seconds: float
    log: str


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None, *, force: bool = False) -> dict[str, BuildInfo]:
    """Compile the named sources (default: all), one ``nvcc`` per source,
    all running at once. ``force`` rebuilds libraries that already exist."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    infos: dict[str, BuildInfo] = {}
    running = {}
    try:
        for name in names:
            out = _target(name)
            if out.exists() and not force:
                log = out.with_suffix(".log")
                infos[name] = BuildInfo(name, out, 0.0, log.read_text()
                                        if log.exists() else "")
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
            running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT,
                                              text=True),
                             tmp, out, time.perf_counter())
        for name, (proc, tmp, out, t0) in running.items():
            text, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {SOURCES[name]}:\n{text}")
            out.with_suffix(".log").write_text(text)
            os.replace(tmp, out)
            infos[name] = BuildInfo(name, out, seconds, text)
    finally:
        for proc, tmp, _, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return infos


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``name``, built first if need be."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name].path))
            _libs[name] = lib
        return lib
