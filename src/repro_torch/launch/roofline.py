"""Roofline terms of a step (PyTorch port of ``repro.launch.roofline``),
on one NVIDIA H100's peaks.

Hardware model: H100 SXM, NVIDIA's data sheet, dense rates without
sparsity, at the full 700 W power limit (a card set below it runs slower
under load):
  bf16 tensor cores    989   TFLOP/s  (``PEAK_FLOPS``, the rate ``derive``
                                       uses, as the reference's is bf16)
  TF32 tensor cores    494.7 TFLOP/s
  f32 outside them      67   TFLOP/s
  HBM3                   3.35 TB/s
  NVLink 4             900   GB/s per GPU, both directions together, so
                       450 GB/s one way (NVIDIA H100 data sheet,
                       "NVLink: 900GB/s")
``chip_smoke.py`` reckons its kernel bounds with the same constants.

Terms per (arch, shape, chips):
  compute    = FLOPs / (chips · peak)
  memory     = HBM bytes / (chips · HBM bandwidth)
  collective = per-chip collective bytes / one-way link bandwidth, and 0
               on one card (no run measures a link yet: ROADMAP A6c)

MODEL_FLOPS = 6·N·D (dense; N = params, D = tokens processed) or 6·N_active·D
for MoE, the "useful compute" yardstick; MODEL_FLOPS / FLOPs exposes
remat and dispatch overhead.

The analytic FLOP and HBM models are the reference's, formula for
formula: the reference uses them because XLA's ``cost_analysis()``
counts a scanned layer once; the port's dry run (``launch/dryrun.py``)
keeps them for the terms and sets a counted figure beside them.
"""
from __future__ import annotations

import dataclasses

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate
PEAK_TF32_FLOPS = 494.7e12   # dense TF32 on the tensor cores
PEAK_F32_FLOPS = 67e12       # f32 FMA outside the tensor cores
PEAK_BYTES = 3.35e12         # HBM3 bytes/s
PEAK_FLOPS = PEAK_BF16_FLOPS   # the rate ``derive`` uses
LINK_BW = 450e9              # NVLink 4 bytes/s, one direction


@dataclasses.dataclass
class RooflineTerms:
    """The reference's record, field for field; ``hlo_gflops`` and
    ``hlo_gbytes`` hold whatever counts the caller passed (the dry run
    passes the analytic models', as the reference's does)."""

    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_gflops: float            # global FLOPs (1e9)
    hlo_gbytes: float            # global HBM bytes (1e9)
    collective_gbytes: float     # per-chip collective payload (1e9)
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_gflops: float
    useful_ratio: float
    note: str = ""

    def row(self) -> dict:
        return dataclasses.asdict(self)


def tokens_processed(shape_kind: str, global_batch: int, seq_len: int) -> int:
    if shape_kind in ("train", "prefill"):
        return global_batch * seq_len
    return global_batch  # decode: one token per sequence


def model_flops(n_active_params: int, n_tokens: int, train: bool) -> float:
    """6·N·D for training (fwd+bwd); 2·N·D for inference forward."""
    mult = 6.0 if train else 2.0
    return mult * n_active_params * n_tokens


def window_list(config) -> list[int]:
    """Per-layer attention window, -1 for global: the reference's
    ``Model._window_list()``, from the config alone (the port's ``Model``
    would allocate every parameter)."""
    from repro_torch.models.model import layer_window
    wins = (layer_window(config, li) for li in range(config.n_layers))
    return [-1 if w is None else w for w in wins]


def analytic_flops(config, shape, cache_size: int | None = None) -> float:
    """Global FLOPs for one step of this (arch, shape)."""
    c = config
    dec = shape.kind == "decode"
    l_ctx_positions = cache_size if dec else shape.seq_len
    tokens = shape.global_batch * (1 if dec else shape.seq_len)
    d = c.d_model

    def attn_ctx(win: int) -> float:
        full = l_ctx_positions if dec else shape.seq_len / 2.0
        if win and win > 0:
            return min(win, full)
        return full

    per_tok = 0.0
    for w in window_list(c) if c.has_attention else []:
        hq, hkv, dh = c.n_heads, c.n_kv_heads, c.head_dim
        per_tok += 2 * d * (2 * hq * dh + 2 * hkv * dh)      # qkvo projections
        per_tok += 4 * attn_ctx(w) * hq * dh                 # scores + values
    if c.has_ssm:
        from repro_torch.models.ssm import ssm_dims
        dims = ssm_dims(c)
        h, p, n, q = dims["nheads"], dims["headdim"], dims["state"], c.ssm_chunk
        per_layer = (2 * d * dims["in_dim"] + 2 * dims["d_inner"] * d
                     + 2 * c.ssm_conv * dims["conv_dim"])
        if dec:
            per_layer += 5 * h * p * n                        # recurrent step
        else:
            per_layer += (q / 2) * h * (2 * n + 2 * p) + 5 * h * p * n
        per_tok += per_layer * c.n_layers
    n_moe = c.n_layers // c.moe_interleave if c.is_moe else 0
    n_dense_ffn = (c.n_layers - n_moe) if c.d_ff > 0 else 0
    per_tok += n_dense_ffn * 2 * 3 * d * c.d_ff
    if c.is_moe:
        per_tok += n_moe * (2 * 3 * d * c.d_ff * c.moe_topk + 2 * d * c.n_experts)

    head_tokens = tokens if shape.kind == "train" else shape.global_batch
    head = 2 * d * c.padded_vocab * head_tokens * c.n_codebooks

    fwd = per_tok * tokens + head
    if shape.kind == "train":
        return 4.0 * fwd          # fwd + bwd(2x) + remat re-fwd
    return fwd


def analytic_hbm_bytes_per_chip(config, shape, n_dp: int, n_mp: int,
                                cache_size: int | None = None,
                                kv_bytes: int = 2) -> float:
    """Per-chip HBM traffic (bytes) for one step; on one card
    ``n_dp = n_mp = 1``."""
    c = config
    chips = n_dp * n_mp
    dec = shape.kind == "decode"
    p_bytes = c.param_count() * 2                            # bf16
    p_local = p_bytes / chips                                # FSDP+TP resident
    p_gathered = p_bytes / n_mp                              # after dp all-gather
    tokens_local = shape.global_batch * (1 if dec else shape.seq_len) / n_dp
    act = tokens_local * c.d_model * 2 * c.n_layers * 10     # activation traffic

    if shape.kind == "train":
        # fwd + remat-fwd + bwd weight reads (gathered), moments r/w (f32 x2),
        # grads reduce + param update
        moments = c.param_count() * 4 * 2 / chips
        return 3 * 2 * p_gathered + 2 * moments * 2 + 2 * p_local + act * 3
    if shape.kind == "prefill":
        kv_write = (c.n_layers * shape.global_batch * shape.seq_len
                    * c.n_kv_heads * c.head_dim * 2 * 2 / chips
                    if c.has_attention else 0.0)
        return 2 * p_gathered + act + kv_write
    # decode: each chip reads its resident weights once per token and its
    # KV slice
    kv = 0.0
    if c.has_attention and cache_size:
        # read + write; kv_bytes=1 for the int8-quantized cache (+ f32
        # scales, 4/head_dim per element)
        per_elem = kv_bytes + 4.0 / c.head_dim
        kv = (c.n_layers * shape.global_batch * cache_size
              * c.n_kv_heads * c.head_dim * per_elem * 2) / chips
    ssm_bytes = 0.0
    if c.has_ssm:
        from repro_torch.models.ssm import ssm_dims
        dims = ssm_dims(c)
        ssm_bytes = (c.n_layers * shape.global_batch * dims["nheads"]
                     * dims["headdim"] * dims["state"] * 4 * 2) / max(n_dp, 1)
    return p_local + kv + ssm_bytes + act


def derive(arch: str, shape_name: str, shape_kind: str, mesh_name: str,
           chips: int, flops: float, bytes_accessed: float,
           collective_bytes_per_chip: float, n_active_params: int,
           global_batch: int, seq_len: int, note: str = "") -> RooflineTerms:
    compute_s = flops / (chips * PEAK_FLOPS)
    memory_s = bytes_accessed / (chips * PEAK_BYTES)
    collective_s = collective_bytes_per_chip / LINK_BW if chips > 1 else 0.0
    dom = max(("compute", compute_s), ("memory", memory_s),
              ("collective", collective_s), key=lambda t: t[1])[0]
    n_tok = tokens_processed(shape_kind, global_batch, seq_len)
    mf = model_flops(n_active_params, n_tok, train=shape_kind == "train")
    return RooflineTerms(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        hlo_gflops=flops / 1e9, hlo_gbytes=bytes_accessed / 1e9,
        collective_gbytes=collective_bytes_per_chip / 1e9,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dom, model_gflops=mf / 1e9,
        useful_ratio=(mf / flops) if flops else 0.0, note=note)
