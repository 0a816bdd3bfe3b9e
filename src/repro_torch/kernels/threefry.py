"""Launch wrapper of the hand-written CUDA draw kernel
(``csrc/threefry.cu``): the counter-based threefry2x32 streams of the
reference's ``jax.random`` on the card. It replaces no TPU kernel; the
reference draws with XLA's own threefry.

Contract (that of ``repro_torch.kernels.ref.threefry_fill_ref``): fill a
contiguous ``out`` with elements ``offset`` .. ``offset + out.numel() - 1``
of a draw of ``key`` (two uint32) in one of the two layouts of
``jax_threefry_partitionable``: ``bits`` into int64, ``uniform`` into
float32, ``normal`` (times ``scale``) into float32 or bfloat16. The
original layout's blocks of 2^32 - 1 elements (``ref.threefry_blocks``)
are one launch each, their keys split on the host. The wrapper checks its
arguments, launches on the current stream without synchronizing, raises
if a launch was refused, and counts one a call in
``launches["threefry_normal"]``, whatever the kind, layout or blocks. It
takes CUDA tensors only: ``ops.threefry_fill`` sends CPU and ``meta``
tensors elsewhere.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (M32, NORMAL_LO, THREEFRY_KINDS,
                                     THREEFRY_LAYOUTS, threefry_blocks)

#: kernel launches in this process; a run sets it to 0 (``reset_launches``)
#: and reads it back to show which path went through the kernel
launches = {"threefry_normal": 0}

OUT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int64: 2}
KIND_DTYPES = {"bits": (torch.int64,), "uniform": (torch.float32,),
               "normal": (torch.float32, torch.bfloat16)}


def reset_launches() -> None:
    launches["threefry_normal"] = 0


def check_args(out: torch.Tensor, key, kind: str, offset: int,
               layout: str = "partitionable", total: int | None = None
               ) -> None:
    """Raise ValueError on anything the kernel (and its plain version)
    does not take. In the original layout a draw's pairing depends on the
    whole draw's size, so a draw at an offset must be told it
    (``total``)."""
    if layout not in THREEFRY_LAYOUTS:
        raise ValueError(f"layout must be one of {THREEFRY_LAYOUTS}, got "
                         f"{layout!r}")
    if layout == "original" and total is None and offset > 0:
        raise ValueError("an original-layout draw at an offset needs the "
                         "whole draw's size (total=)")
    if total is not None and not offset + out.numel() <= total:
        raise ValueError(f"elements {offset} .. {offset + out.numel() - 1} "
                         f"lie past a draw of {total}")
    if kind not in THREEFRY_KINDS:
        raise ValueError(f"kind must be one of {tuple(THREEFRY_KINDS)}, "
                         f"got {kind!r}")
    if out.dtype not in KIND_DTYPES[kind]:
        raise ValueError(f"a {kind} draw fills "
                         f"{' or '.join(map(str, KIND_DTYPES[kind]))}, "
                         f"got {out.dtype}")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    if len(key) != 2 or any(not 0 <= int(k) <= M32 for k in key):
        raise ValueError(f"a key is two uint32, got {key!r}")
    if offset < 0 or offset + out.numel() > 1 << 64:
        raise ValueError(f"counters {offset} .. {offset + out.numel() - 1} "
                         "do not fit in 64 bits")


def _lib() -> ctypes.CDLL:
    lib = build.load("threefry")
    if lib.threefry_launch.argtypes is None:
        u32, i = ctypes.c_uint32, ctypes.c_int
        f, p = ctypes.c_float, ctypes.c_void_p
        # k0 k1 offset n kind out_dtype lo hi scale out stream
        lib.threefry_launch.argtypes = [u32, u32, ctypes.c_uint64,
                                        ctypes.c_int64, i, i, f, f, f, p, p]
        lib.threefry_launch.restype = ctypes.c_int
        # k0 k1 size first n kind out_dtype lo hi scale out stream
        lib.threefry_launch_original.argtypes = [
            u32, u32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int64, i, i,
            f, f, f, p, p]
        lib.threefry_launch_original.restype = ctypes.c_int
        lib.threefry_error_string.argtypes = [i]
        lib.threefry_error_string.restype = ctypes.c_char_p
    return lib


def threefry_cuda(out: torch.Tensor, key, *, kind: str = "normal",
                  offset: int = 0, lo: float = NORMAL_LO, hi: float = 1.0,
                  scale: float = 1.0, layout: str = "partitionable",
                  total: int | None = None) -> torch.Tensor:
    """Fill the CUDA tensor ``out`` in place; returns it."""
    check_args(out, key, kind, offset, layout, total)
    if out.device.type != "cuda":
        raise RuntimeError(f"the CUDA draw kernel takes CUDA tensors, got "
                           f"{out.device}; ops routes CPU tensors to the "
                           "plain version")
    if out.numel() == 0:
        return out
    lib = _lib()
    kind_code, out_code = THREEFRY_KINDS[kind], OUT_CODE[out.dtype]
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        if layout == "partitionable":
            errs = [lib.threefry_launch(
                int(key[0]), int(key[1]), offset, out.numel(), kind_code,
                out_code, lo, hi, scale, out.data_ptr(), stream)]
        else:
            errs = [lib.threefry_launch_original(
                k0, k1, size, first, count, kind_code, out_code, lo, hi,
                scale, out.data_ptr() + at * out.element_size(), stream)
                for (k0, k1), size, first, count, at
                in threefry_blocks(key, total, offset, out.numel())]
    for err in errs:
        if err != 0:
            msg = lib.threefry_error_string(err).decode()
            raise RuntimeError(f"threefry launch failed: {msg}")
    build.count_launch(launches, "threefry_normal")
    return out
