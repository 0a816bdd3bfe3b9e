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
CPU tensors to the plain version. Its output has no autograd history, so
it refuses operands that require grad while grad mode is on: training
goes through ``ops.flash_attention``, whose ``torch.autograd.Function``
runs ``flash_attention_fwd_cuda`` (the same kernel, also writing each
row's log-sum-exp) and, in the backward, ``flash_attention_bwd_cuda``.

The backward (row 9b, no TPU counterpart: the JAX package differentiates
its jnp blockwise attention with XLA) computes dQ, dK and dV from q, k,
v, the forward's output and log-sum-exp and the output's gradient. It has
the forward's contract and returns the gradients in the operands' dtype;
each call adds one to ``launches["flash_attention_bwd"]``, however many
launches it makes. At qwen2-vl-2b's training step (B=8, L=128, H=12,
HKV=2, D=128, bf16, causal) it is bound by bytes: 14.7 MB, 0.0044 ms on
an H100. The work: dK and dV, one block a key tile, KV head and slice of
the tile's (query head, query tile) items, summing its share of the
query-head group in the block; dQ, one block a query tile and head.
Launches on the current stream: ``Di = rowsum(dO * O)``; the dK/dV and
dQ blocks (bf16: in one launch; f32: two); with more than one slice, a
launch that sums the slices' f32 partials in their order. bf16 runs every
product on the tensor cores (P and dS carried as two bf16 parts), f32 on
CUDA-core FMAs. ``bwd_plan`` picks the slices: the fewest that give the
dK/dV blocks one an SM (5 at qwen2-vl's shape, where one block a key
tile gives 32), and the wrapper allocates their partials (10.5 MB there,
in the L2). No atomics: a gradient is the same from run to run.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

#: kernel launches in this process; a run sets it to 0 (``reset_launches``)
#: and reads it back to show which path went through the kernel
launches = {"flash_attention": 0, "flash_attention_bwd": 0}

HEAD_DIMS = (64, 128)   # the kernel's instantiations (D in the source)
TILE = 64               # query rows and keys of a tile (BQ, BK in the source)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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
        # q k v out lse dtype B Lq Lk H HKV D causal window n_sink scale stream
        lib.flash_attention_launch.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                               i, i, i, i, i, ctypes.c_float,
                                               p]
        lib.flash_attention_launch.restype = ctypes.c_int
        # q k v out dout lse di part dq dk dv dtype B Lq Lk H HKV D causal
        # window n_sink splits scale stream
        lib.flash_attention_bwd_split_launch.argtypes = [p] * 11 + [i] * 11 + [
            ctypes.c_float, p]
        lib.flash_attention_bwd_split_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd would record an op on these operands."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _check_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"the CUDA {name} takes CUDA tensors, got {dev}; "
                           "ops routes CPU tensors to the plain version")
    return dev


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()}")


def _forward(q, k, v, causal, window, n_sink, scale, lse):
    dev = _check_cuda("flash attention", q, k, v)
    lib = _lib()
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), DTYPE_CODE[q.dtype], b,
            lq, lk, h, hkv, d, int(causal), -1 if window is None else window,
            n_sink, scale, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "flash_attention")
    build.count_launch(launches, "flash_attention")
    return out


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         n_sink: int = 0, scale: float | None = None
                         ) -> torch.Tensor:
    """Attention of every query row over its live keys; the (Lq, Lk) scores
    never reach device memory. Refuses operands that require grad (its
    output would carry no gradient): ``ops.flash_attention`` takes them."""
    check_args(q, k, v, window=window, n_sink=n_sink)
    if needs_grad(q, k, v):
        raise RuntimeError("flash_attention_cuda returns no autograd history; "
                           "call ops.flash_attention, whose autograd Function "
                           "runs the backward kernel, for operands that "
                           "require grad")
    return _forward(q, k, v, causal, window, n_sink, scale, None)


def flash_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: int | None = None, n_sink: int = 0,
                             scale: float | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's training form, run by ``ops``' autograd
    Function: (out, lse), lse (B, H, Lq) f32 the log-sum-exp of each row's
    visible scaled scores (-inf for a row that sees nothing). Counted as a
    ``flash_attention`` launch."""
    check_args(q, k, v, window=window, n_sink=n_sink)
    b, lq, h, _ = q.shape
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    return _forward(q, k, v, causal, window, n_sink, scale, lse), lse


def check_bwd_args(q, k, v, out, dout, lse, *, window=None, n_sink=0) -> None:
    """Raise ValueError on anything the backward kernel does not take: the
    forward's contract, ``out`` and ``dout`` shaped and typed as q, ``lse``
    (B, H, Lq) f32, all contiguous on one device."""
    check_args(q, k, v, window=window, n_sink=n_sink)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} must be shaped and typed as q "
                             f"{tuple(q.shape)} {q.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    b, lq, h, _ = q.shape
    if tuple(lse.shape) != (b, h, lq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({b}, {h}, {lq}) float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if not all(t.is_contiguous() for t in (out, dout, lse)):
        raise ValueError("every operand must be contiguous")
    if any(t.data_ptr() % 16 for t in (out, dout)):
        raise ValueError("every operand must start on a 16-byte boundary")
    if len({t.device for t in (q, out, dout, lse)}) != 1:
        raise ValueError("every operand must be on one device")


class BwdPlan(NamedTuple):
    """How the backward cuts its work: ``splits`` slices of each key
    tile's items, the dK/dV blocks and the dQ blocks, and the bytes of the
    f32 partials the wrapper allocates (0 with one slice)."""

    splits: int
    dkdv_blocks: int
    dq_blocks: int
    scratch_bytes: int


def bwd_plan(b: int, lq: int, lk: int, h: int, hkv: int, d: int,
             n_sm: int) -> BwdPlan:
    """The backward's plan for an (B, Lq, H, D) q and (B, Lk, HKV, D) k on
    a card of ``n_sm`` SMs. One dK/dV block a (key tile, KV head, batch
    row) walks all of its tile's items, the (query head, query tile) pairs
    of the group's G = H / HKV heads: few blocks at a small batch with
    grouped heads (32 at qwen2-vl-2b's training step). So each tile's items
    are cut into S contiguous slices, one block each: the smallest S that
    gives at least ``n_sm`` blocks, at most G times the query tiles (the
    most items a key tile has), and 1 where the grid already fills the
    card. Each slice then writes f32 partial dK and dV, (2, S, B, Lk,
    HKV, D), which a last launch sums in slice order."""
    tiles = -(-lk // TILE) * hkv * b
    q_tiles = -(-lq // TILE)
    splits = max(1, min((h // hkv) * q_tiles, -(-n_sm // tiles)))
    scratch = 0 if splits == 1 else 2 * splits * b * lk * hkv * d * 4
    return BwdPlan(splits, tiles * splits, q_tiles * h * b, scratch)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True, window: int | None = None,
                             n_sink: int = 0, scale: float | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """dQ, dK, dV of the prefill attention (the plain version is
    ``ref.flash_attention_bwd_ref``), in the operands' dtype."""
    check_bwd_args(q, k, v, out, dout, lse, window=window, n_sink=n_sink)
    dev = _check_cuda("flash attention backward", q, k, v, out, dout, lse)
    lib = _lib()
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    # a CUDA tensor's device always carries its index
    plan = bwd_plan(b, lq, lk, h, hkv, d, _sm_count(dev.index))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    di = torch.empty((b, h, lq), dtype=torch.float32, device=dev)
    part = torch.empty(plan.scratch_bytes // 4, dtype=torch.float32,
                       device=dev) if plan.splits > 1 else None
    with torch.cuda.device(dev):
        err = lib.flash_attention_bwd_split_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), di.data_ptr(),
            None if part is None else part.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), DTYPE_CODE[q.dtype], b, lq, lk, h,
            hkv, d, int(causal), -1 if window is None else window, n_sink,
            plan.splits, scale, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "flash_attention_bwd")
    build.count_launch(launches, "flash_attention_bwd")
    return dq, dk, dv
