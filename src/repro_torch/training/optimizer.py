"""AdamW with a linear-warmup, cosine-decay schedule (PyTorch port of
``repro.training.optimizer``).

Parameters, gradients and both moments are dicts keyed by the model's
parameter names (``Model.named_parameters()``), where JAX keeps pytrees of
the same leaves. The moments are f32 whatever the parameter's dtype; the
update is computed in f32 and cast back to the parameter's dtype; weight
decay touches only leaves with two or more axes (matrices, the stacked
layers, embeddings: not norms or biases); gradients are clipped by their
global norm first. Every step is a handful of elementwise ops a leaf, so
the state lives on the parameters' device. Updates are in place, as
``torch.optim``'s.

DTensor parameters (a ``Model`` on a mesh) keep their moments in the same
placements (``launch.sharding.opt_pspecs``); each gradient is first
brought to its parameter's placements, then every rank updates its own
shards. The clipping norm is global: each leaf's sum of squares is
reduced across its shards before the square root, as the reference's
``global_norm`` over sharded arrays is.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch.distributed.tensor import DTensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0


@dataclasses.dataclass
class AdamWState:
    """``step`` the number of updates taken (a host int; JAX keeps a 0-d
    int32 array); ``m``, ``v`` the f32 moments by parameter name."""

    step: int
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]


def init_adamw(params: dict[str, torch.Tensor]) -> AdamWState:
    zeros = {n: torch.zeros_like(p, dtype=torch.float32)
             for n, p in params.items()}
    return AdamWState(step=0, m=zeros,
                      v={n: z.clone() for n, z in zeros.items()})


def lr_at(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup, then cosine decay to ``min_lr_ratio * lr``; the
    reference's f32 arithmetic, on the host."""
    f32 = torch.float32
    step_t = torch.tensor(float(step), dtype=f32)
    warm = torch.clamp(step_t / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step_t - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(torch.tensor(math.pi, dtype=f32) * frac))
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return float(cfg.lr * warm * decay)


def _sum_sq(t: torch.Tensor) -> torch.Tensor:
    sq = torch.sum(torch.square(t.to(torch.float32)))
    return sq.full_tensor() if isinstance(sq, DTensor) else sq


def global_norm(tensors) -> torch.Tensor:
    """The f32 L2 norm over every tensor of ``tensors`` (an iterable); a
    DTensor counts whole, every shard of it (a plain 0-d tensor out)."""
    return torch.sqrt(sum(_sum_sq(t) for t in tensors))


#: elements of a leaf updated at a time: the f32 temporaries of one chunk
#: take 256 MB each, where a whole stacked leaf's would take gigabytes
#: (musicgen-large's MLP stack: 805 M elements, 3.2 GB in f32)
CHUNK = 1 << 26


def adamw_update(cfg: AdamWConfig, params: dict[str, torch.Tensor],
                 grads: dict[str, torch.Tensor], state: AdamWState
                 ) -> tuple[dict[str, torch.Tensor], AdamWState, dict]:
    """One AdamW step with global-norm clipping, in place: the new values
    are written into the parameters and moments (as ``torch.optim`` does;
    JAX returns new arrays), so no second copy of either is made. Returns
    (params, state, metrics), the same tensors, with metrics ``lr`` (a
    float) and ``grad_norm`` (the 0-d f32 norm before clipping). Each leaf
    is updated ``CHUNK`` elements at a time, elementwise, so the numbers do
    not depend on it."""
    gnorm = global_norm(grads[n] for n in params)
    clip = torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    # the bias corrections in f32, as the reference's, then as scalars
    b1c = float(1 - torch.tensor(cfg.b1, dtype=torch.float32) ** step)
    b2c = float(1 - torch.tensor(cfg.b2, dtype=torch.float32) ** step)
    with torch.no_grad():
        for name, p in params.items():
            g = grads[name]
            if isinstance(p, DTensor):   # each rank its own shards
                if isinstance(g, DTensor):
                    g = g.redistribute(p.device_mesh, p.placements)
                p, g = p.to_local(), g.to_local()
                m_, v_ = state.m[name].to_local(), state.v[name].to_local()
            else:
                m_, v_ = state.m[name], state.v[name]
            pv, mv, vv = (t.view(-1) for t in (p, m_, v_))
            gv = g.reshape(-1)
            for lo in range(0, p.numel(), CHUNK):
                sl = slice(lo, lo + CHUNK)
                g = gv[sl].to(torch.float32) * clip
                m = cfg.b1 * mv[sl] + (1 - cfg.b1) * g
                v = cfg.b2 * vv[sl] + (1 - cfg.b2) * torch.square(g)
                delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
                pf = pv[sl].to(torch.float32)
                if p.dim() >= 2:   # decay matrices only
                    delta = delta + cfg.weight_decay * pf
                pv[sl] = pf - lr * delta
                mv[sl] = m
                vv[sl] = v
    return params, AdamWState(step=step, m=state.m, v=state.v), \
        {"lr": lr, "grad_norm": gnorm}


def make_train_step(loss_fn: Callable, cfg: AdamWConfig):
    """``loss_fn(params, batch)`` -> scalar loss, where ``params`` maps
    names to the leaves being trained (tensors that require grad, e.g. a
    model's own parameters). Returns ``step(params, opt_state, batch) ->
    (params, opt_state, metrics)``: the loss and every leaf's gradient,
    then ``adamw_update``, which updates the same tensors in place;
    ``metrics`` gains the detached ``loss``."""

    def step(params, opt_state, batch):
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), grads)}
        params, opt_state, metrics = adamw_update(cfg, params, grads,
                                                  opt_state)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return step
