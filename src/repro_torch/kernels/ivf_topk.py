"""Launch wrapper of the hand-written CUDA IVF candidate top-k
(``csrc/ivf_topk.cu``), the Hopper replacement of the TPU kernel
``repro/kernels/ivf_topk.py::ivf_topk_pallas``.

Contract (that of ``repro_torch.kernels.ref.ivf_topk_ref``): queries (B, d)
float32, L2-normalized; keys (N, d) float32, bfloat16 or int8 (int8 scaled
by 1/127 in the kernel), the whole slab; cand (B, M) int32 candidate slot
ids, visible where ``0 <= id < N``; k <= min(32, M). Returns (scores
(B, k) f32 sorted descending, slot ids (B, k) int32), ties to the lowest
candidate position, (-inf, -1) where fewer than k ids are visible.

The wrapper checks its arguments, allocates the outputs and the pass-1
scratch with ``torch.empty``, launches both passes on the current stream
without synchronizing, raises if a launch was refused, and counts its
launches in ``launches["ivf_topk"]``. It takes CUDA tensors only: ``ops``
sends CPU tensors to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cosine_topk import DTYPE_CODE

#: kernel launches in this process; a run sets it to 0 (``reset_launches``)
#: and reads it back to show which path went through the kernel
launches = {"ivf_topk": 0}

MAX_K = 32              # one list entry per lane (csrc/warp_topk.cuh)
MAX_D = 4096            # the query row in shared memory (16 KB)
POS_PER_BLOCK = 2048    # candidate positions per pass-1 block
WARPS = 8               # warps per pass-1 block, one top-k list each


def reset_launches() -> None:
    launches["ivf_topk"] = 0


def check_args(queries: torch.Tensor, keys: torch.Tensor, cand: torch.Tensor,
               k: int) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if queries.dim() != 2 or keys.dim() != 2 or cand.dim() != 2:
        raise ValueError(f"queries, keys and cand must be 2-D, got "
                         f"{tuple(queries.shape)}, {tuple(keys.shape)} and "
                         f"{tuple(cand.shape)}")
    if queries.dtype != torch.float32:
        raise ValueError(f"queries must be float32, got {queries.dtype}")
    if keys.dtype not in DTYPE_CODE:
        raise ValueError(f"keys must be float32, bfloat16 or int8, got "
                         f"{keys.dtype}")
    if cand.dtype != torch.int32:
        raise ValueError(f"cand must be int32, got {cand.dtype}")
    b, d = queries.shape
    n, m = keys.shape[0], cand.shape[1]
    if not (1 <= b <= 65535 and n >= 1 and m >= 1 and 1 <= d <= MAX_D):
        raise ValueError(f"need 1 <= B <= 65535, N >= 1, M >= 1 and "
                         f"1 <= d <= {MAX_D}: B={b} N={n} M={m} d={d}")
    if keys.shape[1] != d or cand.shape[0] != b:
        raise ValueError(f"shape mismatch: queries {tuple(queries.shape)}, "
                         f"keys {tuple(keys.shape)}, cand {tuple(cand.shape)}")
    if not 1 <= k <= min(MAX_K, m):
        raise ValueError(f"k must be within [1, min({MAX_K}, M={m})], got "
                         f"{k}")
    if not all(t.is_contiguous() for t in (queries, keys, cand)):
        raise ValueError("every operand must be contiguous")
    if len({t.device for t in (queries, keys, cand)}) != 1:
        raise ValueError("every operand must be on one device")


def _lib() -> ctypes.CDLL:
    lib = build.load("ivf_topk")
    if lib.ivf_topk_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # q keys key_dtype cand B N M d k chunks part_s part_i out_s out_i
        # stream
        lib.ivf_topk_launch.argtypes = [p, p, i, p, i, i, i, i, i, i,
                                        p, p, p, p, p]
        lib.ivf_topk_launch.restype = ctypes.c_int
        lib.ivf_topk_error_string.argtypes = [i]
        lib.ivf_topk_error_string.restype = ctypes.c_char_p
    return lib


def ivf_topk_cuda(queries: torch.Tensor, keys: torch.Tensor,
                  cand: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over each row's visible candidate ids; the (B, M, d) tensor of
    gathered rows is never built."""
    check_args(queries, keys, cand, k)
    dev = queries.device
    if dev.type != "cuda":
        raise RuntimeError(f"the CUDA IVF top-k takes CUDA tensors, got "
                           f"{dev}; ops routes CPU tensors to the plain "
                           "version")
    lib = _lib()
    b, d = queries.shape
    n, m = keys.shape[0], cand.shape[1]
    chunks = -(-m // POS_PER_BLOCK)
    part_s = torch.empty((b, chunks * WARPS, k), dtype=torch.float32,
                         device=dev)
    part_i = torch.empty((b, chunks * WARPS, k), dtype=torch.int32,
                         device=dev)
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.ivf_topk_launch(
            queries.data_ptr(), keys.data_ptr(), DTYPE_CODE[keys.dtype],
            cand.data_ptr(), b, n, m, d, k, chunks, part_s.data_ptr(),
            part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ivf_topk launch failed: "
                           f"{lib.ivf_topk_error_string(err).decode()}")
    launches["ivf_topk"] += 1
    return out_s, out_i
