"""Launch wrapper of the hand-written CUDA cosine top-k
(``csrc/cosine_topk.cu``), the Hopper replacement of the TPU kernel
``repro/kernels/cosine_topk.py::cosine_topk_pallas``.

Contract (that of ``repro_torch.kernels.ref.cosine_topk_ref``): queries
(B, d) float32, L2-normalized; keys (N, d) float32, bfloat16 or int8 (int8
scaled by 1/127 in the kernel); valid (N,) bool shared by the batch; k <= 8.
Returns (scores (B, k) f32 sorted descending, slot ids (B, k) int32), ties to
the lowest slot id, (-inf, -1) where fewer than k slots are visible.

The wrapper checks its arguments, allocates the outputs and the pass-1
scratch with ``torch.empty``, launches both passes on the current stream
without synchronizing, raises if a launch was refused, and counts launches
in ``launches``. It takes CUDA tensors only: ``ops.cosine_topk`` sends CPU
tensors to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: kernel launches in this process; a run sets it to 0 and reads it back to
#: show which path went through the kernel
launches = 0

MAX_K = 8
BLOCK_Q = 64    # query rows per block of pass 1 (BQ in the source)
BLOCK_N = 128   # keys per tile of pass 1 (BN in the source)
BLOCKS_PER_SM = 4
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def check_args(queries: torch.Tensor, keys: torch.Tensor, valid: torch.Tensor,
               k: int) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if queries.dim() != 2 or keys.dim() != 2:
        raise ValueError(f"queries and keys must be 2-D, got "
                         f"{tuple(queries.shape)} and {tuple(keys.shape)}")
    if valid.dim() != 1:
        raise ValueError(f"valid must be a shared (N,) mask, got "
                         f"{tuple(valid.shape)}; per-row masks are not ported")
    if queries.dtype != torch.float32:
        raise ValueError(f"queries must be float32, got {queries.dtype}")
    if keys.dtype not in _DTYPE_CODE:
        raise ValueError(f"keys must be float32, bfloat16 or int8, got "
                         f"{keys.dtype}")
    if valid.dtype != torch.bool:
        raise ValueError(f"valid must be bool, got {valid.dtype}")
    b, d = queries.shape
    n = keys.shape[0]
    if b < 1 or n < 1 or d < 1:
        raise ValueError(f"empty operand: B={b} N={n} d={d}")
    if keys.shape[1] != d or valid.shape[0] != n:
        raise ValueError(f"shape mismatch: queries {tuple(queries.shape)}, "
                         f"keys {tuple(keys.shape)}, valid {tuple(valid.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be within [1, {MAX_K}], got {k}")
    if not (queries.is_contiguous() and keys.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError("queries, keys and valid must be contiguous")
    if not queries.device == keys.device == valid.device:
        raise ValueError("queries, keys and valid must be on one device")


def split(b: int, n: int, num_sms: int) -> tuple[int, int]:
    """(keys per chunk, chunks) of pass 1: whole 128-key tiles per chunk,
    as few as give about ``BLOCKS_PER_SM`` blocks per SM."""
    q_tiles = -(-b // BLOCK_Q)
    n_tiles = -(-n // BLOCK_N)
    want = max(1, -(-BLOCKS_PER_SM * num_sms // q_tiles))
    per_chunk = -(-n_tiles // want) * BLOCK_N
    return per_chunk, -(-n // per_chunk)


def _lib() -> ctypes.CDLL:
    lib = build.load("cosine_topk")
    if lib.cosine_topk_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cosine_topk_launch.argtypes = [p, p, i, p, i, i, i, i, i, i,
                                           p, p, p, p, p]
        lib.cosine_topk_launch.restype = ctypes.c_int
        lib.cosine_topk_error_string.argtypes = [i]
        lib.cosine_topk_error_string.restype = ctypes.c_char_p
    return lib


def cosine_topk_cuda(queries: torch.Tensor, keys: torch.Tensor,
                     valid: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors (see the module docstring)."""
    global launches
    check_args(queries, keys, valid, k)
    dev = queries.device
    if dev.type != "cuda":
        raise RuntimeError(f"the CUDA cosine top-k takes CUDA tensors, got "
                           f"{dev}; ops.cosine_topk routes CPU tensors to the "
                           "plain version")
    lib = _lib()
    b, d = queries.shape
    n = keys.shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_chunk, chunks = split(b, n, sms)
    part_s = torch.empty((b, chunks, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, chunks, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.cosine_topk_launch(
            queries.data_ptr(), keys.data_ptr(), _DTYPE_CODE[keys.dtype],
            valid.data_ptr(), b, n, d, k, per_chunk, chunks,
            part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(),
            out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cosine_topk launch failed: "
                           f"{lib.cosine_topk_error_string(err).decode()}")
    launches += 1
    return out_s, out_i
