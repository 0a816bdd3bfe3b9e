"""Device meshes of the multi-chip path (PyTorch port of
``repro.launch.mesh``).

single-pod: (16, 16)    axes (data, model)        — 256 ranks
multi-pod:  (2, 16, 16) axes (pod, data, model)   — 512 ranks

A mesh is a ``torch.distributed.DeviceMesh`` over the default process
group, which the caller brings up first: gloo across processes on the CPU
(the tests), NCCL on the card, or the ``fake`` backend of
``fake_world(n)`` for the production dry run, where one process stands
in for rank 0 of n and the tensors live on ``meta``. A mesh asked for
without a default group raises; nothing here starts one quietly.

Functions, not module-level constants: importing this module touches no
process-group state.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

POD_SHAPE, POD_AXES = (16, 16), ("data", "model")
MULTIPOD_SHAPE, MULTIPOD_AXES = (2, 16, 16), ("pod", "data", "model")
MESH_NAMES = {False: "pod_16x16", True: "multipod_2x16x16"}


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str
          ) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs a default process group of "
            f"{math.prod(shape)} ranks: call "
            "torch.distributed.init_process_group first (or fake_world(n) "
            "for a dry run)")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; "
                         f"the default group has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """(16, 16) over (data, model), or (2, 16, 16) over (pod, data,
    model) with ``multi_pod``."""
    if multi_pod:
        return _mesh(MULTIPOD_SHAPE, MULTIPOD_AXES, device_type)
    return _mesh(POD_SHAPE, POD_AXES, device_type)


def make_local_mesh(n_data: int = 2, n_model: int = 2,
                    device_type: str = "cpu") -> DeviceMesh:
    """A small (data, model) mesh for tests: gloo ranks on the CPU."""
    return _mesh((n_data, n_model), ("data", "model"), device_type)


def data_axes_of(mesh: DeviceMesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def model_axes_of(mesh: DeviceMesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a == "model")


def axis_size(mesh: DeviceMesh, axes) -> int:
    """Ranks along ``axes`` (a name, a tuple of names, or None)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in axes)


def fake_world(world_size: int) -> None:
    """Make this process rank 0 of a ``world_size``-rank world on the
    ``fake`` backend: collectives return at once without moving data, so
    a step over ``meta`` tensors traces every rank-0 shape and collective
    of a mesh that no machine here holds. Once a process: a process has
    one default group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
