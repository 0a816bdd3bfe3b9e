"""The model-backed miss path's decoder and its training (PyTorch port of
``repro.models``, every family): ``layers`` (RMSNorm, RoPE and M-RoPE,
SwiGLU), ``attention`` (prefill and decode attention through the
hand-written kernels on CUDA, the prefill's backward through its own
kernel, the KV cache), ``moe``, ``ssm``, ``model`` (``Model``) and
``convert`` (weights from the JAX parameter tree)."""
from repro_torch.models.attention import (KVCache, blockwise_attention,
                                          init_kv_cache)
from repro_torch.models.model import DecodeCaches, Model
from repro_torch.models.ssm import SSMState, init_ssm_state

__all__ = ["Model", "DecodeCaches", "KVCache", "SSMState",
           "blockwise_attention", "init_kv_cache", "init_ssm_state"]
