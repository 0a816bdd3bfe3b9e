"""The model-backed miss path's decoder (PyTorch port of ``repro.models``,
dense family): ``layers``, ``attention`` (prefill and decode attention
through the hand-written kernels on CUDA, the KV cache), ``model``
(``Model``) and ``convert`` (weights from the JAX parameter tree)."""
from repro_torch.models.attention import (KVCache, blockwise_attention,
                                          init_kv_cache)
from repro_torch.models.model import DecodeCaches, Model

__all__ = ["Model", "DecodeCaches", "KVCache", "blockwise_attention",
           "init_kv_cache"]
