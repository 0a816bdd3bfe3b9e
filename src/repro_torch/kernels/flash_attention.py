"""Launch wrapper of the hand-written CUDA prefill flash attention
(``csrc/flash_attention.cu``), the Hopper replacement of the TPU kernel
``repro/kernels/flash_attention.py::flash_attention_pallas``.

Contract (that of ``repro_torch.kernels.ref.flash_attention_ref``): q
(B, Lq, H, D), k and v (B, Lk, HKV, D), all float32 or all bfloat16, D 64
or 128, H a multiple of HKV; query row i sits at position ``i + Lk - Lq``
and sees key j when ``j <= i + Lk - Lq`` (causal) and, with a window,
``j > i + Lk - Lq - window`` or, with attention sinks (hymba's meta
tokens), ``j < n_sink``. Returns (B, Lq, H, D) in q's dtype, sums in f32:
f32 inputs on CUDA cores; bf16 inputs on the tensor cores, with P carried
into P V as two bf16 parts (about 16 bits, within one bf16 ulp of the
output of the plain version).

The wrapper checks its arguments, allocates the output with
``torch.empty``, launches on the current stream without synchronizing,
raises if the launch was refused, and counts its launches in
``launches["flash_attention"]``. It takes CUDA tensors only: ``ops`` sends
CPU tensors to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: kernel launches in this process; a run sets it to 0 (``reset_launches``)
#: and reads it back to show which path went through the kernel
launches = {"flash_attention": 0}

HEAD_DIMS = (64, 128)   # the kernel's instantiations (D in the source)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    launches["flash_attention"] = 0


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               window: int | None = None, n_sink: int = 0) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k and v must be 4-D, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if q.dtype not in DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must be all float32 or all bfloat16, "
                         f"got {q.dtype}, {k.dtype} and {v.dtype}")
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, lk, hkv, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim must be one of {HEAD_DIMS}, got {d}")
    if not (1 <= b <= 65535 and lq >= 1 and lk >= 1 and 1 <= hkv <= h
            and h % hkv == 0):
        raise ValueError(f"need 1 <= B <= 65535, Lq, Lk >= 1 and H a "
                         f"multiple of HKV: B={b} Lq={lq} Lk={lk} H={h} "
                         f"HKV={hkv}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if n_sink < 0:
        raise ValueError(f"n_sink must be >= 0, got {n_sink}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("every operand must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("every operand must start on a 16-byte boundary "
                         "(the kernel loads rows 16 bytes at a time)")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("every operand must be on one device")


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if lib.flash_attention_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # q k v out dtype B Lq Lk H HKV D causal window n_sink scale stream
        lib.flash_attention_launch.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                               i, i, i, i, ctypes.c_float, p]
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         n_sink: int = 0, scale: float | None = None
                         ) -> torch.Tensor:
    """Attention of every query row over its live keys; the (Lq, Lk) scores
    never reach device memory."""
    check_args(q, k, v, window=window, n_sink=n_sink)
    dev = q.device
    if dev.type != "cuda":
        raise RuntimeError(f"the CUDA flash attention takes CUDA tensors, got "
                           f"{dev}; ops routes CPU tensors to the plain "
                           "version")
    lib = _lib()
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPE_CODE[q.dtype], b, lq, lk, h, hkv, d, int(causal),
            -1 if window is None else window, n_sink, scale,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()}")
    build.count_launch(launches, "flash_attention")
    return out
