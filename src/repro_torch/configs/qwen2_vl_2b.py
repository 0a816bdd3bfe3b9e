"""qwen2-vl-2b — VLM backbone with M-RoPE, dynamic resolution
[arXiv:2409.12191]. Backbone only: the ViT encoder + projector is a stub
supplying ``n_prefix`` patch embeddings with (t, h, w) M-RoPE grid
positions; we implement the language decoder that consumes them."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    arch_type="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab=151936,
    mrope=True,
    mrope_sections=(16, 24, 24),
    n_prefix=256,          # stub ViT patch embeddings (16x16 grid)
    rope_theta=1000000.0,
    source="Qwen2-VL-2B M-RoPE [arXiv:2409.12191]",
)
