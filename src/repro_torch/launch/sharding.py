"""Input and decode-cache shapes of every (arch, shape) pair: the part of
``repro.launch.sharding`` that the dry run needs (PyTorch port).

The reference builds ``PartitionSpec``s for XLA (``param_pspecs``,
``opt_pspecs``, ``batch_pspecs``, ``decode_cache_pspecs``); they name
the production mesh's axes and have no one-card counterpart, so they are
not ported (ROADMAP A9). What is kept:
  * ``input_specs``: each model input as a (shape, dtype) pair, where the
    reference gives ``ShapeDtypeStruct``s;
  * ``decode_cache_size``: the KV length of a decode shape;
  * ``decode_cache_specs``: the decode caches themselves, allocated on
    the ``meta`` device by ``Model.init_decode_caches`` (shapes and
    dtypes, no memory).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, ModelConfig


def input_specs(config: ModelConfig, shape: InputShape
                ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of every model input of this (arch, shape):
    ``tokens`` (and ``prefix_emb`` where the config takes frontend
    embeddings, train and prefill only)."""
    b, s = shape.global_batch, shape.seq_len
    books = (config.n_codebooks,) if config.n_codebooks > 1 else ()
    if shape.kind == "decode":
        return {"tokens": ((b, 1) + books, torch.int32)}
    out = {"tokens": ((b, s - config.n_prefix) + books, torch.int32)}
    if config.n_prefix > 0:
        out["prefix_emb"] = ((b, config.n_prefix, config.d_model),
                             torch.float32)
    return out


def decode_cache_size(config: ModelConfig, shape: InputShape) -> int:
    """KV cache length for a decode shape.

    decode_32k keeps the full 32k context. long_500k uses the sub-quadratic
    variant: SSM archs have no KV at all; attention archs fall back to the
    sliding-window ring (long_context_window), the memory-bounded design
    that makes 524k context feasible.
    """
    if shape.name == "long_500k":
        return min(config.long_context_window, shape.seq_len)
    return shape.seq_len


def decode_cache_specs(config: ModelConfig, shape: InputShape,
                       quantized: bool = False):
    """The decode caches of this (arch, shape) on the ``meta`` device, at
    ``pos = seq_len - 1`` as the reference's specs are: a
    ``models.model.DecodeCaches`` whose KV leaves are (L, B, S, HKV, D)
    (int8 with (L, B, S, HKV) f32 scales when ``quantized``) and whose SSM
    leaves are f32."""
    from repro_torch.models.model import Model
    caches = Model(config, device="meta").init_decode_caches(
        shape.global_batch, decode_cache_size(config, shape),
        kv_quantized=quantized)
    if caches.kv is not None:
        caches.kv.pos = shape.seq_len - 1
    return caches
