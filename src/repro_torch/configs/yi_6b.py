"""yi-6b — llama-arch dense with aggressive GQA (kv=4) [arXiv:2403.04652]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    arch_type="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab=64000,
    source="Yi-6B GQA [arXiv:2403.04652]",
)
