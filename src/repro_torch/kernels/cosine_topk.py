"""Launch wrappers of the hand-written CUDA cosine top-k
(``csrc/cosine_topk.cu``), the Hopper replacement of three TPU kernels of
``repro/kernels/cosine_topk.py``:

  ``cosine_topk_cuda``           <- ``cosine_topk_pallas``: shared (N,) mask
  ``cosine_topk_interval_cuda``  <- ``cosine_topk_interval_pallas``: shared
                                    mask and one slot interval per row (the
                                    tenancy path)
  ``cosine_topk_masked_cuda``    <- ``cosine_topk_masked_pallas``: dense
                                    (B, N) mask

Contract (that of ``repro_torch.kernels.ref``): queries (B, d) float32,
L2-normalized; keys (N, d) float32, bfloat16 or int8 (int8 scaled by 1/127
in the kernel); k <= 8. Returns (scores (B, k) f32 sorted descending, slot
ids (B, k) int32), ties to the lowest visible slot id, (-inf, -1) where
fewer than k slots are visible.

Each wrapper checks its arguments, allocates the outputs and the pass-1
scratch with ``torch.empty``, launches both passes on the current stream
without synchronizing, raises if a launch was refused, and counts its
launches in ``launches[name]``. The interval wrapper reads its (B,) operands
back once to check ``starts + sizes <= N`` (one host sync per call). They
take CUDA tensors only: ``ops`` sends CPU tensors to the plain versions.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: kernel launches in this process, by kernel; a run sets them to 0
#: (``reset_launches``) and reads them back to show which path went through
#: which kernel
launches = {"cosine_topk": 0, "cosine_topk_interval": 0,
            "cosine_topk_masked": 0}

MAX_K = 8
BLOCK_Q = 64    # query rows per block of pass 1 (BQ in the source)
BLOCK_N = 128   # keys per tile of pass 1 (BN in the source)
BLOCKS_PER_SM = 4
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check_common(queries: torch.Tensor, keys: torch.Tensor, k: int) -> None:
    if queries.dim() != 2 or keys.dim() != 2:
        raise ValueError(f"queries and keys must be 2-D, got "
                         f"{tuple(queries.shape)} and {tuple(keys.shape)}")
    if queries.dtype != torch.float32:
        raise ValueError(f"queries must be float32, got {queries.dtype}")
    if keys.dtype not in _DTYPE_CODE:
        raise ValueError(f"keys must be float32, bfloat16 or int8, got "
                         f"{keys.dtype}")
    b, d = queries.shape
    n = keys.shape[0]
    if b < 1 or n < 1 or d < 1:
        raise ValueError(f"empty operand: B={b} N={n} d={d}")
    if keys.shape[1] != d:
        raise ValueError(f"shape mismatch: queries {tuple(queries.shape)}, "
                         f"keys {tuple(keys.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be within [1, {MAX_K}], got {k}")


def _check_mask(name: str, mask: torch.Tensor, shape: tuple) -> None:
    if mask.dtype != torch.bool:
        raise ValueError(f"{name} must be bool, got {mask.dtype}")
    if tuple(mask.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(mask.shape)}")


def _check_layout(*tensors: torch.Tensor) -> None:
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("every operand must be contiguous")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("every operand must be on one device")


def check_args(queries: torch.Tensor, keys: torch.Tensor, valid: torch.Tensor,
               k: int) -> None:
    """Raise ValueError on anything the shared-mask kernel does not take."""
    _check_common(queries, keys, k)
    if valid.dim() != 1:
        raise ValueError(f"valid must be a shared (N,) mask, got "
                         f"{tuple(valid.shape)}; a (B, N) mask goes to "
                         "cosine_topk_masked_cuda")
    _check_mask("valid", valid, (keys.shape[0],))
    _check_layout(queries, keys, valid)


def check_masked_args(queries: torch.Tensor, keys: torch.Tensor,
                      mask: torch.Tensor, k: int) -> None:
    """Raise ValueError on anything the dense-mask kernel does not take."""
    _check_common(queries, keys, k)
    _check_mask("mask", mask, (queries.shape[0], keys.shape[0]))
    _check_layout(queries, keys, mask)


def check_interval_args(queries: torch.Tensor, keys: torch.Tensor,
                        valid: torch.Tensor, starts: torch.Tensor,
                        sizes: torch.Tensor, k: int) -> None:
    """Raise ValueError on anything the interval kernel does not take,
    including an interval that leaves the slab (``starts + sizes > N``)."""
    check_args(queries, keys, valid, k)
    b, n = queries.shape[0], keys.shape[0]
    for name, t in (("starts", starts), ("sizes", sizes)):
        if t.dtype != torch.int32 or tuple(t.shape) != (b,):
            raise ValueError(f"{name} must be ({b},) int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    _check_layout(queries, starts, sizes)
    # starts > n - sizes, not starts + sizes > n: no int32 wrap-around
    if bool(((starts < 0) | (sizes < 0) | (starts > n - sizes)).any()):
        raise ValueError(f"every interval must lie within [0, N={n}): need "
                         "0 <= starts, 0 <= sizes, starts + sizes <= N")


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
        tail = [i, i, i, i, i, i, p, p, p, p, p]   # B N d k kpc chunks ...
        lib.cosine_topk_launch.argtypes = [p, p, i, p] + tail
        lib.cosine_topk_interval_launch.argtypes = [p, p, i, p, p, p] + tail
        lib.cosine_topk_masked_launch.argtypes = [p, p, i, p] + tail
        for fn in (lib.cosine_topk_launch, lib.cosine_topk_interval_launch,
                   lib.cosine_topk_masked_launch):
            fn.restype = ctypes.c_int
        lib.cosine_topk_error_string.argtypes = [i]
        lib.cosine_topk_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, queries: torch.Tensor, keys: torch.Tensor,
            masks: tuple[torch.Tensor, ...], k: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel ``name`` on checked operands; ``masks`` are the
    mask-source pointers of its entry point, in order."""
    dev = queries.device
    if dev.type != "cuda":
        raise RuntimeError(f"the CUDA cosine top-k takes CUDA tensors, got "
                           f"{dev}; ops routes CPU tensors to the plain "
                           "version")
    lib = _lib()
    b, d = queries.shape
    n = keys.shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_chunk, chunks = split(b, n, sms)
    part_s = torch.empty((b, chunks, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, chunks, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    entry = getattr(lib, f"{name}_launch")
    with torch.cuda.device(dev):
        err = entry(
            queries.data_ptr(), keys.data_ptr(), _DTYPE_CODE[keys.dtype],
            *(m.data_ptr() for m in masks), b, n, d, k, per_chunk, chunks,
            part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(),
            out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.cosine_topk_error_string(err).decode()}")
    launches[name] += 1
    return out_s, out_i


def cosine_topk_cuda(queries: torch.Tensor, keys: torch.Tensor,
                     valid: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k under a shared (N,) ``valid`` mask."""
    check_args(queries, keys, valid, k)
    return _launch("cosine_topk", queries, keys, (valid,), k)


def cosine_topk_interval_cuda(queries: torch.Tensor, keys: torch.Tensor,
                              valid: torch.Tensor, starts: torch.Tensor,
                              sizes: torch.Tensor, k: int
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k where row ``b`` sees ``valid`` within slots
    ``[starts[b], starts[b] + sizes[b])``; ``sizes[b] == 0`` gives exactly
    (-inf, -1). No (B, N) mask is built."""
    check_interval_args(queries, keys, valid, starts, sizes, k)
    return _launch("cosine_topk_interval", queries, keys,
                   (valid, starts, sizes), k)


def cosine_topk_masked_cuda(queries: torch.Tensor, keys: torch.Tensor,
                            mask: torch.Tensor, k: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k under a dense (B, N) ``mask``, aliveness folded in by the
    caller."""
    check_masked_args(queries, keys, mask, k)
    return _launch("cosine_topk_masked", queries, keys, (mask,), k)
