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
           "make_local_mesh_ctx", "gather_cuda_over_gloo_through_c10d"]


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


def _group_of(group):
    """The ``ProcessGroup`` of a functional collective's ``group``
    argument when it is one or a (mesh, dim) pair, else None."""
    if isinstance(group, dist.ProcessGroup):
        return group
    if (isinstance(group, tuple) and len(group) == 2
            and isinstance(group[0], DeviceMesh)):
        return group[0].get_group(group[1])
    return None


def _cuda_on_gloo(t: torch.Tensor, pg) -> bool:
    return t.is_cuda and dist.get_backend(pg) == "gloo"


def _c10d_all_gather(funcol_all_gather, route=_cuda_on_gloo):
    """``funcol_all_gather`` (the functional all-gather DTensor gathers a
    shard with), routed through c10d's ``all_gather_into_tensor`` where
    ``route`` says (a CUDA tensor on a gloo group): torch 2.11's
    functional all-gather of a CUDA tensor over gloo ends its process in a
    segmentation fault, in every dtype, where c10d's own all-gather and
    the functional all-reduce, reduce-scatter and all-to-all work (two
    gloo ranks on one card).  The result is the same: the ranks' blocks
    stacked on dim 0, then moved to ``gather_dim``."""
    def all_gather(self, gather_dim, group, tag=""):
        pg = _group_of(group)
        if pg is None or not route(self, pg):
            return funcol_all_gather(self, gather_dim, group, tag)
        world = dist.get_world_size(pg)
        out = self.new_empty((world * self.shape[0],) + tuple(self.shape[1:]))
        dist.all_gather_into_tensor(out, self.contiguous(), group=pg)
        if gather_dim % self.dim():
            out = torch.cat(out.chunk(world, dim=0), dim=gather_dim)
        return out

    all_gather.through_c10d = True
    return all_gather


def gather_cuda_over_gloo_through_c10d() -> None:
    """Route the functional all-gathers that DTensor takes
    (``all_gather_tensor`` in torch 2.11, ``all_gather_single`` in later
    versions) through ``_c10d_all_gather``, once a process: global state,
    for a process whose CUDA mesh runs over gloo (``make_local_mesh_ctx``
    calls it for one)."""
    import torch.distributed._functional_collectives as funcol
    for name in ("all_gather_tensor", "all_gather_single"):
        fn = getattr(funcol, name, None)
        if fn is not None and not getattr(fn, "through_c10d", False):
            setattr(funcol, name, _c10d_all_gather(fn))


def make_local_mesh_ctx(data: int = 1, model: int = 1, *,
                        device_type: str = "cuda") -> MeshCtx:
    """A (data, model) mesh over the process group's ranks, on the card
    unless ``device_type`` names another (``"cpu"``: gloo ranks on the
    CPU, as the tests run them).  A CUDA mesh over gloo (two ranks on one
    card: NCCL takes no two) gathers through c10d
    (``gather_cuda_over_gloo_through_c10d``)."""
    ops.register_swa_sharding()
    if device_type == "cuda" and dist.get_backend() == "gloo":
        gather_cuda_over_gloo_through_c10d()
    mesh = DeviceMesh(device_type, _grid((data, model)),
                      mesh_dim_names=("data", "model"))
    return MeshCtx(mesh=mesh, data_axes=("data",), model_axis="model")
