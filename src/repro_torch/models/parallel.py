"""Tensor-parallel pieces of the model on a mesh: collectives with the
gradients a Megatron layout needs (the reference's ``psum``/``pmean``
inside ``shard_map``, whose transposes JAX derives), and the
vocab-parallel embedding lookup.

Inside a ``local_map`` each rank holds local tensors; these functions
take the ``DeviceMesh`` and the mesh dims to reduce over, and run one
functional all-reduce a dim.
"""
from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate


def mesh_dims(mesh, axes) -> tuple[int, ...]:
    """The mesh dims of the named ``axes`` (None: none)."""
    return tuple(mesh.mesh_dim_names.index(a) for a in axes or ())


class SumOver(torch.autograd.Function):
    """All-reduce (sum) over mesh dims whose consumers are replicated
    across them: the backward is the identity (the reference's ``psum``
    closing a sharded contraction, Megatron's row-parallel exit)."""

    @staticmethod
    def forward(ctx, t, mesh, dims):
        for dim in dims:
            t = funcol.all_reduce(t, "sum", (mesh, dim))
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class MeanOver(torch.autograd.Function):
    """All-reduce (mean) over mesh dims, consumers replicated: the
    backward spreads the gradient evenly (``pmean``)."""

    @staticmethod
    def forward(ctx, t, mesh, dims):
        ctx.n = 1
        for dim in dims:
            t = funcol.all_reduce(t, "avg", (mesh, dim))
            ctx.n *= mesh.size(dim)
        return t

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


class GradSumOver(torch.autograd.Function):
    """The identity forward; the backward all-reduces (sums) the gradient
    over mesh dims: a replicated input entering work split over them
    (Megatron's column-parallel entry)."""

    @staticmethod
    def forward(ctx, t, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        for dim in ctx.dims:
            g = funcol.all_reduce(g, "sum", (ctx.mesh, dim))
        return g, None, None



def vocab_embedding(table: DTensor, tokens: DTensor, model_axes) -> DTensor:
    """``F.embedding(tokens, table)`` for a (V, d) table whose vocab is
    sharded over ``model_axes``: each rank looks up the tokens in its own
    vocab rows (zeros for the others) and one all-reduce over
    ``model_axes`` sums the lookups, so the table stays in place. Rows
    out with the tokens' placements over the other axes, replicated over
    ``model_axes``; the table's gradient is partial over the axes the
    tokens shard over (each rank's tokens), as DTensor keeps it."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    dims = mesh_dims(mesh, model_axes)
    _, offset = compute_local_shape_and_global_offset(
        table.shape, mesh, table.placements)
    lo = offset[0]
    tok_p = tuple(Replicate() if i in dims else p
                  for i, p in enumerate(tokens.placements))
    grad_p = tuple(p if i in dims else
                   (Partial() if tok_p[i] != Replicate() else p)
                   for i, p in enumerate(table.placements))

    def fn(tl, idx):
        mine = (idx >= lo) & (idx < lo + tl.shape[0])
        rows = F.embedding(torch.where(mine, idx - lo, 0), tl)
        return SumOver.apply(rows * mine[..., None].to(rows.dtype), mesh,
                             dims)

    return local_map(fn, out_placements=list(tok_p),
                     in_placements=(table.placements, tok_p),
                     in_grad_placements=(grad_p, tok_p), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)
