"""Architecture + input-shape config system (PyTorch port of
``repro.configs.base``, copied unchanged).

One ``ModelConfig`` covers all six assigned arch families (dense / moe /
ssm / hybrid / audio / vlm); per-arch files under ``repro_torch/configs/``
instantiate it with the exact assigned hyperparameters. ``reduced()``
derives the CPU smoke-test variant (<=2 layers, d_model<=512, <=4 experts)
of the same family.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


def pad_vocab(vocab: int, multiple: int = 512) -> int:
    """Megatron-style vocab padding so the embedding shards over `model`."""
    return int(math.ceil(vocab / multiple) * multiple)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                   # query heads (0 for attn-free ssm)
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    source: str = ""               # citation (paper/model card)

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    moe_topk: int = 0
    moe_interleave: int = 1        # MoE every k-th layer (llama4: 2)
    capacity_factor: float = 1.25

    # --- SSM (mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- hybrid (hymba) ------------------------------------------------------
    n_meta_tokens: int = 0
    global_attn_every: int = 0     # hybrid: full-attn layer period (else SWA)

    # --- positions -----------------------------------------------------------
    rope_theta: float = 10000.0
    mrope: bool = False            # qwen2-vl M-RoPE
    mrope_sections: tuple[int, int, int] = (16, 24, 24)

    # --- modality frontend stubs (audio/vlm) ---------------------------------
    n_prefix: int = 0              # frame/patch embeddings prepended (stub)
    n_codebooks: int = 1           # musicgen EnCodec codebooks

    # --- attention policy -----------------------------------------------------
    sliding_window: Optional[int] = None    # if set: SWA everywhere
    long_context_window: int = 8192         # window used for long_500k variant

    # --- numerics -------------------------------------------------------------
    dtype: str = "bfloat16"
    vocab_pad_multiple: int = 512

    def __post_init__(self):
        if self.arch_type not in ("dense", "moe", "ssm", "hybrid", "audio", "vlm"):
            raise ValueError(f"unknown arch_type {self.arch_type!r}")
        if self.arch_type == "moe" and (self.n_experts <= 0 or self.moe_topk <= 0):
            raise ValueError("moe arch needs n_experts and moe_topk")
        if self.arch_type in ("ssm", "hybrid") and self.ssm_state <= 0:
            raise ValueError(f"{self.arch_type} arch needs ssm_state")
        if self.n_heads and self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError("n_heads must be a multiple of n_kv_heads")

    # ------------------------------------------------------------------ #
    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab, self.vocab_pad_multiple)

    @property
    def has_attention(self) -> bool:
        return self.arch_type != "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.arch_type in ("ssm", "hybrid")

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def n_layer_groups(self) -> int:
        return self.n_layers // self.moe_interleave

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, ff, l = self.d_model, self.d_ff, self.n_layers
        total = self.padded_vocab * d  # embed
        total += self.padded_vocab * d * self.n_codebooks  # lm head(s)
        if self.has_attention:
            qkvo = d * self.n_heads * self.head_dim * 2 \
                + d * self.n_kv_heads * self.head_dim * 2
            total += l * qkvo
        if self.has_ssm:
            dz = 2 * self.d_inner + 2 * self.ssm_ngroups * self.ssm_state \
                + self.ssm_nheads
            total += l * (d * dz + self.d_inner * d)
        if self.is_moe:
            n_moe = l // self.moe_interleave
            n_dense = l - n_moe
            total += n_moe * self.n_experts * 3 * d * ff + n_moe * d * self.n_experts
            total += n_dense * 3 * d * ff
        elif ff > 0:
            total += l * 3 * d * ff
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only routed experts count)."""
        if not self.is_moe:
            return self.param_count()
        d, ff, l = self.d_model, self.d_ff, self.n_layers
        total = self.param_count()
        n_moe = l // self.moe_interleave
        total -= n_moe * (self.n_experts - self.moe_topk) * 3 * d * ff
        return total

    # ------------------------------------------------------------------ #
    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family, tiny dims (runs 1 step on CPU)."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2 * self.moe_interleave if self.is_moe else 2,
            d_model=256,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_heads else 0,
            head_dim=64,
            d_ff=512 if self.d_ff else 0,
            vocab=1024,
            n_experts=min(self.n_experts, 4) if self.is_moe else 0,
            moe_topk=min(self.moe_topk, 2) if self.is_moe else 0,
            ssm_state=min(self.ssm_state, 16) if self.has_ssm else 0,
            capacity_factor=8.0,   # no drops at toy batch sizes (continuity tests)
            ssm_headdim=32 if self.has_ssm else 64,
            ssm_chunk=32,
            n_meta_tokens=min(self.n_meta_tokens, 8),
            n_prefix=min(self.n_prefix, 16),
            mrope_sections=(8, 12, 12) if self.mrope else self.mrope_sections,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
            long_context_window=64,
            vocab_pad_multiple=128,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned (seq_len, global_batch) workloads."""

    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
