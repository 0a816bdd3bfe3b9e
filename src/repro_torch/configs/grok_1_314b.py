"""grok-1-314b — 8-expert top-2 MoE [hf:xai-org/grok-1]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    arch_type="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab=131072,
    n_experts=8,
    moe_topk=2,
    moe_interleave=1,
    source="Grok-1 8e top-2 MoE [hf:xai-org/grok-1]",
)
