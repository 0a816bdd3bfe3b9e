"""Dispatch of the port's kernels by the device of their tensors (PyTorch
port of ``repro.kernels.ops``): CUDA tensors go to the hand-written kernel,
CPU tensors to its plain PyTorch version in ``ref``. There is no switch
that sends CUDA tensors to the plain version; ``chip_smoke.py`` calls it
directly to compare.

Per-row visibility dispatches as in the JAX package:
  * ``valid`` (N,)    -> the shared-mask kernel (single-tenant path);
  * interval operands -> the interval kernel, O(B) operands (tenancy);
  * ``valid`` (B, N)  -> the dense-mask kernel (general per-row masks).
``quant_cosine_topk`` dispatches an int8 slab with per-row scales
(``cosine_topk.quantize_keys``) by ``valid`` the same way; its interval
form has no dispatch here, as in the JAX ``ops``, and is called as
``cosine_topk.quant_cosine_topk_interval_cuda``.

``ivf_topk`` dispatches the IVF candidate kernel the same way, with the
``backend`` override of ``IVFIndex``; ``flash_attention`` (prefill) and
``decode_attention`` (one token over a KV cache) dispatch the attention
kernels of the model-backed miss path; ``threefry_fill`` the draw kernel
of ``repro_torch.prng``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import decode_attention as kdecode
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import threefry as kthreefry
from repro_torch.kernels.cosine_topk import (check_args, check_interval_args,
                                             check_masked_args,
                                             check_quant_args,
                                             check_quant_masked_args,
                                             cosine_topk_cuda,
                                             cosine_topk_interval_cuda,
                                             cosine_topk_masked_cuda,
                                             quant_cosine_topk_cuda,
                                             quant_cosine_topk_masked_cuda)
from repro_torch.kernels.ivf_topk import check_args as check_ivf_args
from repro_torch.kernels.ivf_topk import check_contract as check_ivf_contract
from repro_torch.kernels.ivf_topk import ivf_topk_cuda

BACKENDS = ("auto", "torch", "kernel")


def cosine_topk(queries: torch.Tensor, keys: torch.Tensor, valid: torch.Tensor,
                *, k: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked cosine top-k; ``valid`` is (N,) shared by the batch or (B, N)
    per row."""
    masked = valid.dim() == 2
    if queries.device.type == "cuda":
        if masked:
            return cosine_topk_masked_cuda(queries, keys, valid, k)
        return cosine_topk_cuda(queries, keys, valid, k)
    if masked:
        check_masked_args(queries, keys, valid, k)
    else:
        check_args(queries, keys, valid, k)
    return ref.cosine_topk_ref(queries, keys, valid, k)


def cosine_topk_interval(queries: torch.Tensor, keys: torch.Tensor,
                         valid: torch.Tensor, starts: torch.Tensor,
                         sizes: torch.Tensor, *, k: int = 4
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Row ``b`` sees ``valid`` within ``[starts[b], starts[b] + sizes[b])``
    — the tenancy path."""
    if queries.device.type == "cuda":
        return cosine_topk_interval_cuda(queries, keys, valid, starts, sizes,
                                         k)
    check_interval_args(queries, keys, valid, starts, sizes, k)
    return ref.cosine_topk_interval_ref(queries, keys, valid, starts, sizes,
                                        k)


def quant_cosine_topk(queries: torch.Tensor, keys_q: torch.Tensor,
                      scales: torch.Tensor, valid: torch.Tensor, *, k: int = 4
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked cosine top-k over int8 ``keys_q`` with per-row (N,) f32
    ``scales``; ``valid`` is (N,) shared or (B, N) per row."""
    masked = valid.dim() == 2
    if queries.device.type == "cuda":
        if masked:
            return quant_cosine_topk_masked_cuda(queries, keys_q, scales,
                                                 valid, k)
        return quant_cosine_topk_cuda(queries, keys_q, scales, valid, k)
    if masked:
        check_quant_masked_args(queries, keys_q, scales, valid, k)
    else:
        check_quant_args(queries, keys_q, scales, valid, k)
    return ref.quant_cosine_topk_ref(queries, keys_q, scales, valid, k)


def ivf_topk(queries: torch.Tensor, keys: torch.Tensor, cand: torch.Tensor,
             *, k: int = 4, backend: str = "auto",
             probe: torch.Tensor | None = None,
             buckets: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """IVF candidate top-k: ``cand`` is (B, M) int32 candidate slot ids, -1
    marking every invisible candidate (``IVFIndex.candidates`` folds bucket
    validity, aliveness, tenancy and per-row duplicates into the ids).
    ``probe`` (B, P) and ``buckets`` (C, cap) int32, M == P * cap, give the
    grouping the kernel works by: each entry ``cand[b, j * cap + t]`` must
    be -1 or ``buckets[probe[b, j], t]``. The plain route checks that
    contract and raises ValueError on a violation (the result does not
    depend on the grouping); the card trusts it.
    ``backend`` is ``'auto'`` (follow the device of the tensors),
    ``'torch'`` (the plain version on any device) or ``'kernel'`` (the CUDA
    kernel; raises on CPU tensors)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "kernel" or (backend == "auto"
                               and queries.device.type == "cuda"):
        return ivf_topk_cuda(queries, keys, cand, k, probe=probe,
                             buckets=buckets)
    check_ivf_args(queries, keys, cand, k, probe, buckets)
    if probe is not None:
        check_ivf_contract(cand, probe, buckets)
    return ref.ivf_topk_ref(queries, keys, cand, k)


class FlashAttention(torch.autograd.Function):
    """Prefill attention with its backward: on CUDA tensors the forward
    kernel in its training form (it also writes each row's log-sum-exp)
    and the backward kernel (row 9b); on CPU tensors their plain versions
    (``ref.flash_attention_lse_ref``, ``ref.flash_attention_bwd_ref``), so
    the CPU runs the same wiring. ``ops.flash_attention`` takes this route
    whenever an operand requires grad."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, n_sink, scale):
        kw = dict(causal=causal, window=window, n_sink=n_sink, scale=scale)
        if q.device.type == "cuda":
            out, lse = kflash.flash_attention_fwd_cuda(q, k, v, **kw)
        else:
            kflash.check_args(q, k, v, window=window, n_sink=n_sink)
            out, lse = ref.flash_attention_lse_ref(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if q.device.type == "cuda":
            grads = kflash.flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                                    **ctx.kw)
        else:
            grads = ref.flash_attention_bwd_ref(q, k, v, out, dout, lse,
                                                **ctx.kw)
        return (*grads, None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    n_sink: int = 0, scale: float | None = None
                    ) -> torch.Tensor:
    """Prefill attention: q (B, Lq, H, D), k/v (B, Lk, HKV, D), query
    offset ``Lk - Lq``; with a window, keys ``j < n_sink`` stay visible
    (hymba's meta-token sinks). When an operand requires grad (and grad
    mode is on) it runs through ``FlashAttention``, whose backward is the
    backward kernel on CUDA; otherwise the forward kernel alone."""
    if kflash.needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, n_sink, scale)
    if q.device.type == "cuda":
        return kflash.flash_attention_cuda(q, k, v, causal=causal,
                                           window=window, n_sink=n_sink,
                                           scale=scale)
    kflash.check_args(q, k, v, window=window, n_sink=n_sink)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   n_sink=n_sink, scale=scale)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, slot_pos: torch.Tensor, pos: int,
                     *, window: int | None = None, n_sink: int = 0,
                     scale: float | None = None,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None,
                     return_lse: bool = False):
    """Decode attention: q (B, 1, H, D) over one layer's (B, S, HKV, D)
    cache, int8 with (B, S, HKV) scales. With ``return_lse`` it returns
    (output in q's dtype, (B, H) f32 log-sum-exp, -inf where no slot is
    visible) on both routes, the parts that ``models.attention.merge_lse``
    merges. Inference only: it raises for operands that require grad on
    either device."""
    kw = dict(window=window, n_sink=n_sink, k_scale=k_scale, v_scale=v_scale)
    if kflash.needs_grad(q, k_cache, v_cache):
        raise RuntimeError("decode attention has no backward (neither its "
                           "kernel nor, to keep one wiring, its plain "
                           "version here): decode under torch.no_grad()")
    if q.device.type == "cuda":
        return kdecode.decode_attention_cuda(q, k_cache, v_cache, slot_pos,
                                             pos, scale=scale,
                                             return_lse=return_lse, **kw)
    kdecode.check_args(q, k_cache, v_cache, slot_pos, **kw)
    if not return_lse:
        return ref.decode_attention_ref(q, k_cache, v_cache, slot_pos, pos,
                                        scale=scale, **kw)
    o, lse = ref.decode_attention_ref(q, k_cache, v_cache, slot_pos, pos,
                                      scale=scale, return_lse=True, **kw)
    return o.to(q.dtype), lse


def threefry_fill(out: torch.Tensor, key, *, kind: str = "normal",
                  offset: int = 0, lo: float = ref.NORMAL_LO, hi: float = 1.0,
                  scale: float = 1.0, layout: str = "partitionable",
                  total: int | None = None) -> torch.Tensor:
    """Fill ``out`` in place with elements ``offset`` on of a draw of
    ``key`` of ``total`` elements in ``layout`` (``kernels.threefry``):
    the kernel on CUDA, the plain version on the CPU, nothing on ``meta``
    (shapes only). Returns ``out``."""
    kw = dict(kind=kind, offset=offset, lo=lo, hi=hi, scale=scale,
              layout=layout, total=total)
    if out.device.type == "cuda":
        return kthreefry.threefry_cuda(out, key, **kw)
    kthreefry.check_args(out, key, kind, offset, layout, total)
    if out.device.type == "meta":
        return out
    return ref.threefry_fill_ref(out, key, **kw)
