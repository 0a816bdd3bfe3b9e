"""Weights across packages: the JAX ``Model.init_params`` tree, as numpy
arrays, into the port's ``Model`` state.

Every leaf maps one to one (``embed``, ``lm_head`` (audio: with a
leading codebook axis), ``final_norm``, ``prefix_proj`` (audio, vlm),
``meta_tokens``, ``blocks/<name>`` -> ``blocks.<name>`` and the SSM
layers' ``blocks/ssm/<name>`` -> ``blocks.ssm.<name>``), with its shape
and dtype kept; bfloat16 leaves (numpy's ``ml_dtypes`` bfloat16) are
carried bit for bit. The same renaming carries a gradient tree across.
``tree_from_jax`` keeps a tree's nesting instead, for the MiniLM encoder
(``embedding.encoder``), whose parameters are a plain dict tree.
Nothing here imports JAX: the caller turns the tree into numpy first, e.g.
``jax.tree_util.tree_map(np.asarray, params)``.
"""
from __future__ import annotations

import numpy as np
import torch


def to_tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a CPU tensor of the same dtype; bfloat16 by its
    bits, since torch cannot read numpy's bfloat16 directly."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """The JAX parameter tree (nested dicts of numpy arrays) as a state
    dict for ``Model.load_state_dict`` (strict: every leaf must match):
    the path's keys joined by dots, e.g. ``blocks/ssm/in_proj`` ->
    ``blocks.ssm.in_proj``."""
    state = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            for sub, arr in params_from_jax(leaf).items():
                state[f"{name}.{sub}"] = arr
        else:
            state[name] = to_tensor(leaf)
    return state


def tree_from_jax(tree: dict, device="cpu") -> dict:
    """A JAX parameter tree (nested dicts of numpy arrays, e.g. the
    encoder's ``init_encoder_params``) as the same nesting of tensors on
    ``device``, each leaf's shape and dtype kept."""
    return {name: tree_from_jax(leaf, device) if isinstance(leaf, dict)
            else to_tensor(leaf).to(device) for name, leaf in tree.items()}
