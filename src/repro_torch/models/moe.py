"""Mixture-of-Experts block (PyTorch port of ``repro.models.moe``):
GShard-style capacity dispatch.

Token dispatch is a static-shape scatter into ``(E, C, d)`` expert buffers
(capacity ``ceil(T * k / E * capacity_factor)``; tokens past an expert's
capacity are dropped and keep only their residual, standard Switch
behaviour); the expert FFNs run as one batched SwiGLU over E
(``torch.bmm``, as the JAX package leaves its einsums to XLA). The JAX
package runs all of it in plain jnp, outside any Pallas kernel, so it is
plain PyTorch here too.

grok-1: E=8, top-2, every layer. llama4-maverick: E=128, top-1, every
second layer (the interleave is the model's).

On a mesh (``moe_ffn_sharded``, the reference's ``shard_map`` form, here
a ``local_map``) the expert weights are tensor-parallel: d_ff shards over
``model``, so no all-to-all is needed. Each rank holds every expert's d_ff
slice, dispatches its own data shard's tokens (capacity from the *local*
token count, as in the reference, so with drops the sharded result is not
the unsharded one), computes its partial down-projection, and one
all-reduce over ``model`` closes the contraction.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.models.parallel import GradSumOver, MeanOver, SumOver, \
    mesh_dims


def router(x: torch.Tensor, w_router: torch.Tensor, topk: int
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Softmax gating. x (T, d) -> (gates (T, k) in x's dtype, experts
    (T, k) int32, aux () f32).

    Logits and softmax in f32. The top k come from a stable descending
    sort, so of two tied probabilities the lower expert ranks first, as
    ``jax.lax.top_k`` ranks them (``torch.topk`` promises no order among
    ties). Aux is the Switch/GShard load-balance loss ``E * sum_e f_e *
    p_e``: f_e the share of tokens whose first choice is e, p_e the mean
    router probability of e."""
    logits = x.to(torch.float32) @ w_router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = ranked[:, :topk], order[:, :topk]
    gates = gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9)
    e = probs.shape[-1]
    f = F.one_hot(experts[:, 0], e).to(torch.float32).mean(dim=0)
    p = probs.mean(dim=0)
    aux = e * torch.sum(f * p)
    return gates.to(x.dtype), experts.to(torch.int32), aux


def dispatch_indices(experts: torch.Tensor, n_experts: int, capacity: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each (token, choice) its slot in its expert's capacity buffer.

    Returns (slots (T, k) int32, -1 = dropped; counts (E,) int32, every
    choice counted, dropped or not). Ranks are assigned choice-major (all
    tokens' first choices first), the GShard convention that biases drops
    toward lower-gate choices."""
    counts = torch.zeros((n_experts,), dtype=torch.int32,
                         device=experts.device)
    slots = []
    for j in range(experts.shape[1]):
        oh = F.one_hot(experts[:, j].long(), n_experts).to(torch.int32)
        ranks = torch.cumsum(oh, dim=0, dtype=torch.int32) - 1 + counts[None]
        slot = torch.sum(ranks * oh, dim=-1, dtype=torch.int32)
        slots.append(torch.where(slot < capacity, slot, -1))
        counts = counts + oh.sum(dim=0, dtype=torch.int32)
    return torch.stack(slots, dim=1), counts


def moe_ffn(x: torch.Tensor, w_router: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, *, topk: int,
            capacity_factor: float = 1.25, model_axes=None, mesh=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (T, d); w_router (d, E); w_gate, w_up (E, d, F); w_down (E, F, d).
    Returns (y (T, d) in x's dtype, aux_loss ()). With ``model_axes`` (of
    ``mesh``; inside ``moe_ffn_sharded``'s local map, F the local d_ff
    slice) one all-reduce over them closes the down-projection's sharded
    d_ff, and the gradient reaching x through the experts is summed over
    them.

    The buffers and expert GEMMs are in x's dtype; the gated combine sums
    in f32 in choice order and rounds once, as the JAX package does. A
    dropped choice scatters zeros into slot (0, 0) (``index_put_`` with
    accumulation, the reference's ``.at[].add``) and gathers nothing."""
    t, d = x.shape
    e = w_gate.shape[0]
    capacity = max(int(math.ceil(t * topk / e * capacity_factor)), 1)
    gates, experts, aux = router(x, w_router, topk)
    slots, _ = dispatch_indices(experts, e, capacity)

    where = []
    for j in range(topk):
        ok = slots[:, j] >= 0
        where.append((ok, torch.where(ok, experts[:, j], 0).long(),
                      torch.where(ok, slots[:, j], 0).long()))
    dims = mesh_dims(mesh, model_axes)
    xe = GradSumOver.apply(x, mesh, dims) if dims else x
    buf = x.new_zeros((e, capacity, d))
    zero = x.new_zeros(())
    for ok, idx_e, idx_c in where:
        buf.index_put_((idx_e, idx_c), torch.where(ok[:, None], xe, zero),
                       accumulate=True)

    h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    y_buf = torch.bmm(h, w_down)
    if dims:   # close the sharded d_ff contraction
        y_buf = SumOver.apply(y_buf, mesh, dims)

    y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for j, (ok, idx_e, idx_c) in enumerate(where):
        yj = y_buf[idx_e, idx_c].to(torch.float32)
        y = y + torch.where(ok[:, None],
                            gates[:, j:j + 1].to(torch.float32) * yj, 0.0)
    return y.to(x.dtype), aux


def moe_ffn_sharded(mesh, data_axes: tuple[str, ...],
                    model_axes: tuple[str, ...]):
    """The MoE FFN over ``mesh`` (``local_map``, the reference's
    ``shard_map``): tokens (T, d) shard over ``data_axes``, the router
    replicates, ``w_gate``/``w_up`` (E, d, F) shard F and ``w_down``
    (E, F, d) its F over ``model_axes``. Each rank routes and dispatches
    its own tokens (``dispatch_indices`` runs on local tensors); ``aux`` is
    averaged over the data axes into one replicated scalar. It is the same
    on every model rank already, so no reduction runs over ``model``: the
    reference's ``pmean`` there is an identity whose backward must not
    divide (the router's and x's gradients replicate over ``model``).
    Returns ``fn(x, w_router, w_gate, w_up, w_down, *, topk,
    capacity_factor) -> (y, aux)`` on DTensors; the weights' gradients are
    partial over the data axes (each rank's tokens), and DTensor sums
    them."""
    from torch.distributed.tensor.experimental import local_map
    names = mesh.mesh_dim_names
    data, model = set(data_axes), set(model_axes)

    def place(data_p, model_p, other=Replicate()):
        return tuple(data_p if n in data else model_p if n in model
                     else other for n in names)

    x_p = place(Shard(0), Replicate())
    rep = place(Replicate(), Replicate())
    in_p = (x_p, rep, place(Replicate(), Shard(2)),
            place(Replicate(), Shard(2)), place(Replicate(), Shard(1)))
    grad_p = (x_p, place(Partial(), Replicate()), place(Partial(), Shard(2)),
              place(Partial(), Shard(2)), place(Partial(), Shard(1)))
    mean_dims = mesh_dims(mesh, data_axes)

    def fn(x, w_router, w_gate, w_up, w_down, topk, capacity_factor):
        y, aux = moe_ffn(x, w_router, w_gate, w_up, w_down, topk=topk,
                         capacity_factor=capacity_factor,
                         model_axes=model_axes, mesh=mesh)
        return y, MeanOver.apply(aux, mesh, mean_dims) if mean_dims \
            else aux

    mapped = local_map(fn, out_placements=(x_p, rep), in_placements=in_p
                       + (None, None), in_grad_placements=grad_p
                       + (None, None), device_mesh=mesh,
                       redistribute_inputs=True)

    def wrapped(x, w_router, w_gate, w_up, w_down, *, topk,
                capacity_factor):
        return mapped(x, w_router, w_gate, w_up, w_down, topk,
                      capacity_factor)

    return wrapped
