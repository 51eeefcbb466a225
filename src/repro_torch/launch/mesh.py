"""Mesh builders (counterpart of ``repro.launch.mesh``): functions, never
module-level meshes, so importing this module touches no process group.

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the default process
group, which the caller starts (``init_process_group``: gloo or NCCL on
real ranks).  ``fake_process_group`` starts the fake group that the dry
run traces under: any world size, one process, collectives that move
nothing; it is global state, so a dry run under a mesh runs in a process
of its own.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..kernels import ops
from ..sharding import MeshCtx

__all__ = ["fake_process_group", "make_production_mesh", "make_mesh_ctx",
           "make_local_mesh_ctx"]


def fake_process_group(world_size: int, rank: int = 0) -> None:
    """Start the fake process group of ``world_size`` ranks, this process
    being ``rank`` (``torch.testing._internal.distributed.fake_pg``);
    nothing if one is already up at that size."""
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is up; the mesh needs {world_size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def _grid(shape):
    n = 1
    for s in shape:
        n *= s
    return torch.arange(n).reshape(shape)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 = 256 cards as (``data``, ``model``); multi_pod adds a
    leading 2-pod axis (2 x 16 x 16 = 512 cards).  A ``cuda`` mesh takes
    the collectives NCCL would (an all-to-all where DTensor gives a CPU
    mesh an all-gather); over the fake group it needs no card."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    ops.register_swa_sharding()
    return DeviceMesh("cuda", _grid(shape), mesh_dim_names=axes)


def make_mesh_ctx(*, multi_pod: bool = False) -> MeshCtx:
    mesh = make_production_mesh(multi_pod=multi_pod)
    data_axes = ("pod", "data") if multi_pod else ("data",)
    return MeshCtx(mesh=mesh, data_axes=data_axes, model_axis="model")


def make_local_mesh_ctx(data: int = 1, model: int = 1, *,
                        device_type: str = "cuda") -> MeshCtx:
    """A (data, model) mesh over the process group's ranks, on the card
    unless ``device_type`` names another (``"cpu"``: gloo ranks on the
    CPU, as the tests run them)."""
    ops.register_swa_sharding()
    mesh = DeviceMesh(device_type, _grid((data, model)),
                      mesh_dim_names=("data", "model"))
    return MeshCtx(mesh=mesh, data_axes=("data",), model_axis="model")
