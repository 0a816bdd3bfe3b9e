"""Weights across packages: the JAX ``Model.init_params`` tree, as numpy
arrays, into the port's ``Model`` state.

Every leaf maps one to one (``embed``, ``lm_head``, ``final_norm`` and
``blocks/<name>`` -> ``blocks.<name>``), with its shape and dtype kept;
bfloat16 leaves (numpy's ``ml_dtypes`` bfloat16) are carried bit for bit.
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
    dict for ``Model.load_state_dict`` (strict: every leaf must match)."""
    state = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            for sub, arr in leaf.items():
                if isinstance(arr, dict):
                    raise NotImplementedError(
                        f"nested leaf {name}/{sub} (SSM parameters) arrives "
                        "with the ssm slice of the port")
                state[f"{name}.{sub}"] = to_tensor(arr)
        else:
            state[name] = to_tensor(leaf)
    return state
