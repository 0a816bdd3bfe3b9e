"""llama3-405b — frontier dense, GQA, 128k vocab [arXiv:2407.21783]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    arch_type="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab=128256,
    rope_theta=500000.0,
    source="Llama-3.1 405B [arXiv:2407.21783]",
)
