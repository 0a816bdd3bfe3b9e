"""``repro_torch.launch.comm_stats``: the collectives a step dispatches,
counted by kind with the reference's per-chip conventions
(``repro.launch.hlo_analysis``: all-gather its result, reduce-scatter and
all-to-all their operand, all-reduce twice its operand), in a fake world
of 4 ranks on ``meta`` tensors at known shapes; and one row-parallel MLP
layer, whose exit is an all-reduce of its activation (twice its bytes),
or a reduce-scatter (once) with the sequence sharded."""
import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, \
    distribute_tensor

from repro.launch import hlo_analysis
from repro_torch.launch import comm_stats
from repro_torch.launch.comm_stats import CollectiveCounter
from repro_torch.launch.mesh import fake_world, make_local_mesh

F32 = 4


@pytest.fixture(scope="module")
def mesh():
    """A (2, 2) mesh over (data, model): this process is rank 0 of a
    fake world of 4, torn down after the module."""
    assert not dist.is_initialized()
    fake_world(4)
    try:
        yield make_local_mesh(2, 2)
    finally:
        dist.destroy_process_group()


def _place(mesh, shape, placements):
    return distribute_tensor(torch.empty(shape, device="meta"), mesh,
                             placements, src_data_rank=None)


def test_conventions_are_the_references():
    assert comm_stats.MULT == hlo_analysis._COLLECTIVE_MULT
    assert set(comm_stats.KINDS) == set(hlo_analysis._COLLECTIVE_MULT)


def test_all_gather_counts_its_result(mesh):
    x = _place(mesh, (8, 16), [Replicate(), Shard(0)])     # local (4, 16)
    with CollectiveCounter() as cc:
        x.redistribute(mesh, [Replicate(), Replicate()])
    stats = cc.stats()
    assert stats["bytes"] == {"all-gather": 8 * 16 * F32}
    assert stats["count"] == {"all-gather": 1.0}
    assert stats["static_count"]["all-gather"] == 1
    assert stats["total_bytes"] == 8 * 16 * F32


def test_reduce_scatter_counts_its_operand(mesh):
    p = DTensor.from_local(torch.empty((8, 16), device="meta"), mesh,
                           [Replicate(), Partial()])
    with CollectiveCounter() as cc:
        p.redistribute(mesh, [Replicate(), Shard(0)])
    assert cc.stats()["bytes"] == {"reduce-scatter": 8 * 16 * F32}


def test_all_reduce_counts_twice_its_operand(mesh):
    p = DTensor.from_local(torch.empty((8, 16), device="meta"), mesh,
                           [Partial(), Replicate()])
    with CollectiveCounter() as cc:
        p.redistribute(mesh, [Replicate(), Replicate()])
        funcol.all_reduce(torch.empty((3,), device="meta"), "sum", (mesh, 1))
    stats = cc.stats()
    assert stats["bytes"] == {"all-reduce": 2 * (8 * 16 + 3) * F32}
    assert stats["count"] == {"all-reduce": 2.0}


def test_all_to_all_counts_its_operand(mesh):
    t = torch.empty((8, 16), device="meta")
    with CollectiveCounter() as cc:
        funcol.all_to_all_single(t, None, None, (mesh, 1))
    assert cc.stats()["bytes"] == {"all-to-all": 8 * 16 * F32}
    assert cc.stats()["static_count"]["collective-permute"] == 0


def test_nothing_counted_without_a_collective(mesh):
    x = _place(mesh, (8, 16), [Shard(0), Replicate()])
    with CollectiveCounter() as cc:
        (x * 2).redistribute(mesh, [Shard(0), Shard(1)])   # a local chunk
    assert cc.stats()["total_bytes"] == 0.0
    assert cc.stats()["bytes"] == {}


@pytest.mark.parametrize("seq_parallel", [False, True])
def test_row_parallel_mlp_exit(mesh, seq_parallel):
    """A Megatron MLP layer: x (B, L, d) with its batch over data, the
    gate and up column-parallel, the down row-parallel. Its only
    collective is the exit: an all-reduce of the (local) activation,
    counted twice, or with the sequence over model a reduce-scatter,
    counted once."""
    b, l, d, ff = 4, 8, 16, 32
    x = _place(mesh, (b, l, d), [Shard(0), Replicate()])
    gate = _place(mesh, (d, ff), [Replicate(), Shard(1)])
    up = _place(mesh, (d, ff), [Replicate(), Shard(1)])
    down = _place(mesh, (ff, d), [Replicate(), Shard(0)])
    out_p = [Shard(0), Shard(1) if seq_parallel else Replicate()]
    with CollectiveCounter() as cc:
        y = (F.silu(x @ gate) * (x @ up)) @ down
        assert y.placements == (Shard(0), Partial())
        y = y.redistribute(mesh, out_p)
    activation = (b // 2) * l * d * F32       # this rank's rows
    stats = cc.stats()
    if seq_parallel:
        assert stats["bytes"] == {"reduce-scatter": activation}
    else:
        assert stats["bytes"] == {"all-reduce": 2 * activation}
    assert stats["total_bytes"] == activation * (1 if seq_parallel else 2)
