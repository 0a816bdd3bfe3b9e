"""Launch wrapper of the hand-written CUDA draw kernel
(``csrc/threefry.cu``): the counter-based threefry2x32 streams of the
reference's ``jax.random`` on the card. It replaces no TPU kernel; the
reference draws with XLA's own threefry.

Contract (that of ``repro_torch.kernels.ref.threefry_fill_ref``): fill a
contiguous ``out`` with the draws of counters ``offset`` .. ``offset +
out.numel() - 1`` of ``key`` (two uint32): ``bits`` into int64,
``uniform`` into float32, ``normal`` (times ``scale``) into float32 or
bfloat16. The wrapper checks its arguments, launches on the current
stream without synchronizing, raises if the launch was refused, and
counts one launch a call in ``launches["threefry_normal"]``, whatever the
kind. It takes CUDA tensors only: ``ops.threefry_fill`` sends CPU and
``meta`` tensors elsewhere.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import M32, NORMAL_LO, THREEFRY_KINDS

#: kernel launches in this process; a run sets it to 0 (``reset_launches``)
#: and reads it back to show which path went through the kernel
launches = {"threefry_normal": 0}

OUT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int64: 2}
KIND_DTYPES = {"bits": (torch.int64,), "uniform": (torch.float32,),
               "normal": (torch.float32, torch.bfloat16)}


def reset_launches() -> None:
    launches["threefry_normal"] = 0


def check_args(out: torch.Tensor, key, kind: str, offset: int) -> None:
    """Raise ValueError on anything the kernel (and its plain version)
    does not take."""
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
        lib.threefry_error_string.argtypes = [i]
        lib.threefry_error_string.restype = ctypes.c_char_p
    return lib


def threefry_cuda(out: torch.Tensor, key, *, kind: str = "normal",
                  offset: int = 0, lo: float = NORMAL_LO, hi: float = 1.0,
                  scale: float = 1.0) -> torch.Tensor:
    """Fill the CUDA tensor ``out`` in place; returns it."""
    check_args(out, key, kind, offset)
    if out.device.type != "cuda":
        raise RuntimeError(f"the CUDA draw kernel takes CUDA tensors, got "
                           f"{out.device}; ops routes CPU tensors to the "
                           "plain version")
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(out.device):
        err = lib.threefry_launch(
            int(key[0]), int(key[1]), offset, out.numel(),
            THREEFRY_KINDS[kind], OUT_CODE[out.dtype], lo, hi, scale,
            out.data_ptr(), torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        msg = lib.threefry_error_string(err).decode()
        raise RuntimeError(f"threefry launch failed: {msg}")
    build.count_launch(launches, "threefry_normal")
    return out
