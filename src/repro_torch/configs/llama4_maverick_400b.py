"""llama4-maverick-400b-a17b — 128-expert top-1 MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E family].

moe_interleave=2 (MoE on every second layer) matches the published
active-parameter count (~17B active / ~400B total).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    arch_type="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    n_experts=128,
    moe_topk=1,
    moe_interleave=2,
    source="Llama-4 Maverick MoE [hf:meta-llama/Llama-4-Scout-17B-16E]",
)
