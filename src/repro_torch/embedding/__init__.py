"""Embedding generation (paper §2.2): the hash n-gram embedder and the
MiniLM-class encoder. Both produce L2-normalized vectors compatible with
the cache."""
from repro_torch.embedding.encoder import (EncoderConfig, MINILM_L6, encode,
                                           init_encoder_params)
from repro_torch.embedding.hash_embedder import HashEmbedder
from repro_torch.embedding.lsh import SimHashLSH, cosine

__all__ = ["HashEmbedder", "EncoderConfig", "MINILM_L6", "encode",
           "init_encoder_params", "SimHashLSH", "cosine"]
