"""hymba-1.5b — hybrid: parallel attention + mamba heads per layer, meta
tokens, SWA with periodic global layers [arXiv:2411.13676]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=64,
    n_meta_tokens=128,
    global_attn_every=8,      # every 8th layer full attention, rest SWA
    sliding_window=1024,
    source="Hymba hybrid-head 1.5B [arXiv:2411.13676]",
)
