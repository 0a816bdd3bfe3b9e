"""Shardings of every tree the dry run builds, and the input and
decode-cache shapes of every (arch, shape) pair (PyTorch port of
``repro.launch.sharding``).

A spec is the counterpart of a ``PartitionSpec``: a tuple with one entry
per tensor dim, each an axis name, a tuple of axis names (a dim split over
several mesh axes, major first, e.g. ``("pod", "data")``) or None
(replicated). ``placements(mesh, spec)`` turns one into DTensor
placements. The conventions are the reference's:
  * weights shard their *fused feature* dim over ``model`` (always
    divisible, unlike head counts: hymba 25H/5KV, qwen2-vl 2KV ...);
  * embeddings/heads shard the (padded) vocab over ``model``;
  * batch shards over the data axes (``("pod", "data")`` multi-pod);
  * decode KV caches shard batch over data and *sequence over model*
    (context-parallel decode: kv_heads are often < 16);
  * SSM parameters and states replicate over ``model``.
The trees are keyed as the port's state dict (``blocks.wq``,
``blocks.ssm.in_proj``, ...); the stacked leaves have the JAX leaves'
leading axes, so each spec carries over position by position.

Shapes, as before: ``input_specs`` gives each model input as a (shape,
dtype) pair, where the reference gives ``ShapeDtypeStruct``s;
``decode_cache_size`` the KV length of a decode shape;
``decode_cache_specs`` the decode caches on ``meta``.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.training.optimizer import AdamWState

#: the production axis sizes ``_divisible`` checks against without a mesh
PRODUCTION_SIZES = {"pod": 2, "data": 16, "model": 16}

_MODEL_LAST = ("wq", "wk", "wv", "mlp_gate", "mlp_up", "moe_gate", "moe_up")
_MODEL_ROWS = ("wo", "mlp_down", "moe_down")


def _leaf_spec(config: ModelConfig, name: str, ndim: int) -> tuple:
    spec = [None] * ndim
    leaf = name.rsplit(".", 1)[-1]
    if name == "embed":
        spec[-2] = "model"              # (Vp, d) or (C, Vp, d)
    elif name == "lm_head":
        spec[-1] = "model"              # (d, Vp) or (C, d, Vp)
    elif name == "prefix_proj":
        spec[1] = "model"
    elif name.startswith("blocks.ssm."):
        pass                            # replicated
    elif leaf in _MODEL_LAST:
        spec[3] = "model"
    elif leaf in _MODEL_ROWS:
        spec[2] = "model"
    return tuple(spec)


def param_pspecs(config: ModelConfig, dp: tuple[str, ...] = ("data",)
                 ) -> dict[str, tuple]:
    """Spec of every parameter, by state-dict name (``dp`` is unused, as
    in the reference: no parameter shards over data)."""
    from repro_torch.models.model import Model
    model = Model(config, device="meta")
    return {n: _leaf_spec(config, n, p.dim())
            for n, p in model.named_parameters()}


def opt_pspecs(param_specs: dict[str, tuple]) -> AdamWState:
    """AdamW moments inherit the parameter shardings; the step count is a
    replicated scalar."""
    return AdamWState(step=(), m=dict(param_specs), v=dict(param_specs))


def _divisible(n: int, axes, mesh=None) -> bool:
    """Whether ``n`` splits evenly over ``axes`` (and is at least their
    size): the mesh's sizes where one is given, else the production
    axis sizes, the reference's conservative static check."""
    if axes is None:
        return False
    if mesh is not None:
        from repro_torch.launch.mesh import axis_size
        total = axis_size(mesh, axes)
    else:
        total = math.prod(PRODUCTION_SIZES[a] for a in axes)
    return n % total == 0 and n >= total


def batch_pspecs(config: ModelConfig, shape: InputShape, dp: tuple[str, ...],
                 mesh=None) -> dict[str, tuple]:
    """Input shardings for tokens (and prefix_emb where the config takes
    frontend embeddings)."""
    bspec = dp if _divisible(shape.global_batch, dp, mesh) else None
    tok = (bspec, None, None) if config.n_codebooks > 1 else (bspec, None)
    if config.n_prefix > 0:
        return {"tokens": tok, "prefix_emb": (bspec, None, None)}
    return {"tokens": tok}


def decode_cache_pspecs(config: ModelConfig, batch: int, dp: tuple[str, ...],
                        quantized: bool = False, mesh=None):
    """Specs of the decode caches: a ``DecodeCaches`` of specs. KV
    (L, B, S, HKV, D) shards batch over data and S over model; the int8
    cache's (L, B, S, HKV) scales the same; an unquantized cache has no
    scales (None). ``slot_pos`` is replicated, ``pos`` a host int (its
    spec the empty tuple)."""
    from repro_torch.models.attention import KVCache
    from repro_torch.models.model import DecodeCaches
    from repro_torch.models.ssm import SSMState
    bspec = dp if _divisible(batch, dp, mesh) else None
    kv = None
    if config.has_attention:
        scale = (None, bspec, "model", None) if quantized else None
        kv = KVCache(k=(None, bspec, "model", None, None),
                     v=(None, bspec, "model", None, None),
                     slot_pos=(None,), pos=(), k_scale=scale, v_scale=scale)
    ssm = None
    if config.has_ssm:
        ssm = SSMState(conv=(None, bspec, None, None),
                       ssd=(None, bspec, None, None, None))
    return DecodeCaches(kv=kv, ssm=ssm)


def placements(mesh, spec: tuple) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` where tensor dim d names its axis, else ``Replicate()``.
    A dim named by several axes is ``Shard(d)`` on each of them, which
    DTensor splits in mesh-dim order; so the axes must be named in that
    order (major first)."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} must follow the "
                             f"mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} "
                                 "named twice")
            out[i] = Shard(d)
    return tuple(out)


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
                       quantized: bool = False, model=None):
    """The decode caches of this (arch, shape) on the ``meta`` device, at
    ``pos = seq_len - 1`` as the reference's specs are: a
    ``models.model.DecodeCaches`` whose KV leaves are (L, B, S, HKV, D)
    (int8 with (L, B, S, HKV) f32 scales when ``quantized``) and whose SSM
    leaves are f32. ``model``, a ``Model`` on ``meta`` (one on a mesh
    places the caches by ``decode_cache_pspecs``), defaults to an
    unsharded one."""
    from repro_torch.models.model import Model
    model = model or Model(config, device="meta")
    caches = model.init_decode_caches(
        shape.global_batch, decode_cache_size(config, shape),
        kv_quantized=quantized)
    if caches.kv is not None:
        caches.kv.pos = shape.seq_len - 1
    return caches
