"""Launch wrapper of the hand-written CUDA IVF candidate top-k
(``csrc/ivf_topk.cu``), the Hopper replacement of the TPU kernel
``repro/kernels/ivf_topk.py::ivf_topk_pallas``.

Contract (that of ``repro_torch.kernels.ref.ivf_topk_ref``): queries (B, d)
float32, L2-normalized; keys (N, d) float32, bfloat16 or int8 (int8 scaled
by 1/127 in the kernel), the whole slab; cand (B, M) int32 candidate slot
ids, visible where ``0 <= id < N``; k <= min(32, M). Returns (scores
(B, k) f32 sorted descending, slot ids (B, k) int32), ties to the lowest
candidate position, (-inf, -1) where fewer than k ids are visible.

The grouping (``probe``, ``buckets``): ``IVFIndex`` builds cand from a probe
(B, P) int32, the probed bucket of each block of ``cap`` positions, and its
bucket table (C, cap) int32 of slot ids, with ``M == P * cap``: every entry
``cand[b, j * cap + t]`` is either -1 or ``buckets[probe[b, j], t]``. Given
both, the kernel stages each probed bucket's live members once and scores
them against every row that probed the bucket. The card does not check the
contract (``check_contract`` does, on any device, with a sync; ``ops``
runs it on the CPU route); a cand that breaks it gets scores of the bucket
members at the positions where it is visible. Without them, the kernel's
entry point describes cand as groups of one: each row's chunk of 2,048
positions is its own bucket, and the same kernel runs.

The wrapper checks its arguments, allocates the outputs and the pass-1
scratch (its size from the kernel's own plan) with ``torch.empty``,
launches both passes on the current stream
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
MAX_D = 4096            # a tile of 8 staged rows fits in shared memory
MAX_P = 32              # probes a row in the grouped form


def reset_launches() -> None:
    launches["ivf_topk"] = 0


def check_args(queries: torch.Tensor, keys: torch.Tensor, cand: torch.Tensor,
               k: int, probe: torch.Tensor | None = None,
               buckets: torch.Tensor | None = None) -> None:
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
    operands = [queries, keys, cand]
    if (probe is None) != (buckets is None):
        raise ValueError("probe and buckets go together")
    if probe is not None:
        if probe.dim() != 2 or buckets.dim() != 2:
            raise ValueError(f"probe and buckets must be 2-D, got "
                             f"{tuple(probe.shape)} and "
                             f"{tuple(buckets.shape)}")
        if probe.dtype != torch.int32 or buckets.dtype != torch.int32:
            raise ValueError(f"probe and buckets must be int32, got "
                             f"{probe.dtype} and {buckets.dtype}")
        p, (c, cap) = probe.shape[1], buckets.shape
        if probe.shape[0] != b or not 1 <= p <= MAX_P or c < 1 \
                or p * cap != m:
            raise ValueError(f"need probe (B={b}, P) with 1 <= P <= "
                             f"{MAX_P}, buckets (C >= 1, cap) and M == P * "
                             f"cap: probe {tuple(probe.shape)}, buckets "
                             f"{tuple(buckets.shape)}, M={m}")
        operands += [probe, buckets]
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("every operand must be contiguous")
    if len({t.device for t in operands}) != 1:
        raise ValueError("every operand must be on one device")


def check_contract(cand: torch.Tensor, probe: torch.Tensor,
                   buckets: torch.Tensor) -> None:
    """Raise ValueError unless every probe names a bucket of the table and
    every entry ``cand[b, j * cap + t]`` is -1 or ``buckets[probe[b, j],
    t]``. Reads the tensors back: on the card it waits for them."""
    c = buckets.shape[0]
    if bool(((probe < 0) | (probe >= c)).any()):
        raise ValueError(f"probe names a bucket outside [0, {c})")
    want = buckets[probe.long()].reshape(cand.shape)
    bad = (cand != -1) & (cand != want)
    if bool(bad.any()):
        b, pos = (int(x) for x in bad.nonzero()[0])
        raise ValueError(
            f"cand breaks the grouping: cand[{b}, {pos}] = "
            f"{int(cand[b, pos])}, neither -1 nor the bucket member "
            f"{int(want[b, pos])}")


def _lib() -> ctypes.CDLL:
    lib = build.load("ivf_topk")
    if lib.ivf_topk_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # q keys key_dtype cand probe buckets B N M d k P C cap scratch
        # out_s out_i stream
        lib.ivf_topk_launch.argtypes = [p, p, i, p, p, p, i, i, i, i, i,
                                        i, i, i, p, p, p, p]
        lib.ivf_topk_launch.restype = ctypes.c_int
        # key_dtype grouped B N M d k P C cap
        lib.ivf_topk_scratch_bytes.argtypes = [i] * 10
        lib.ivf_topk_scratch_bytes.restype = ctypes.c_longlong
        lib.ivf_topk_error_string.argtypes = [i]
        lib.ivf_topk_error_string.restype = ctypes.c_char_p
    return lib


def ivf_topk_cuda(queries: torch.Tensor, keys: torch.Tensor,
                  cand: torch.Tensor, k: int, *,
                  probe: torch.Tensor | None = None,
                  buckets: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over each row's visible candidate ids; the (B, M, d) tensor of
    gathered rows is never built. With ``probe`` (B, P) and ``buckets``
    (C, cap), each entry of ``cand`` must be -1 or ``buckets[probe[b, j],
    t]`` at position ``j * cap + t`` (not checked here)."""
    check_args(queries, keys, cand, k, probe, buckets)
    dev = queries.device
    if dev.type != "cuda":
        raise RuntimeError(f"the CUDA IVF top-k takes CUDA tensors, got "
                           f"{dev}; ops routes CPU tensors to the plain "
                           "version")
    lib = _lib()
    b, d = queries.shape
    n, m = keys.shape[0], cand.shape[1]
    code = DTYPE_CODE[keys.dtype]
    # the grouping's (P, C, cap); without it the kernel's entry point
    # derives its own and reads none of these
    p, (c, cap) = ((probe.shape[1], buckets.shape) if probe is not None
                   else (0, (0, 0)))
    scratch = torch.empty(lib.ivf_topk_scratch_bytes(
        code, probe is not None, b, n, m, d, k, p, c, cap),
        dtype=torch.uint8, device=dev)
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.ivf_topk_launch(
            queries.data_ptr(), keys.data_ptr(), code, cand.data_ptr(),
            None if probe is None else probe.data_ptr(),
            None if buckets is None else buckets.data_ptr(), b, n, m, d, k,
            p, c, cap, scratch.data_ptr(), out_s.data_ptr(),
            out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ivf_topk launch failed: "
                           f"{lib.ivf_topk_error_string(err).decode()}")
    build.count_launch(launches, "ivf_topk")
    return out_s, out_i
