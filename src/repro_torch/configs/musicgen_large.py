"""musicgen-large — decoder-only transformer over EnCodec audio tokens
[arXiv:2306.05284]. Backbone only: the conv/codec frontend is a stub that
supplies conditioning frame embeddings (``n_prefix``); the decoder models
4 EnCodec codebooks with summed embeddings + per-codebook heads (delay
pattern handled in the data pipeline)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=2048,
    n_codebooks=4,
    n_prefix=64,          # stub conditioning embeddings (T5-style prefix)
    vocab_pad_multiple=128,
    source="MusicGen-large decoder [arXiv:2306.05284]",
)
