"""Sharding of the port, counterpart of ``repro.sharding``: the mesh
context of the LM stack, and the trial-axis sharding of the Monte-Carlo
sweeps.

**Mesh** (``MeshCtx``, ``mesh_context``, ``current_mesh_ctx``,
``axis_size``, ``shard``, the placeholders ``DATA``, ``MODEL``, ``BOTH``).
``MeshCtx`` carries the axis names of a ``torch.distributed`` device mesh
(``launch/mesh.py``: over gloo or NCCL, or over the fake process group of
the dry run), so model code never hard-codes a mesh shape; without a
context every helper is a no-op.  ``shard`` is the reference's sharding
constraint with its divisibility fallback: a dim is sharded only if the
axis size divides it, else it stays replicated and the event is recorded
in ``MeshCtx.fallbacks`` as the reference's tuple.  On a ``DTensor`` it is
a ``redistribute`` to the resolved placements; a plain tensor (a local
block inside ``local_map``) is returned as it is.

**Trials** (``TRIAL_AXIS``, ``trial_devices``, ``chunk_blocks``,
``issue_order``: the layout of the reference's ``trial_mesh`` /
``shard_trials``).  The JAX package vmaps a chunk scan over a device
axis and lets GSPMD split it.  The port deals whole chunks instead: the
global chunk sequence is cut into contiguous blocks, one a device
(``chunk_blocks``), each device runs its block through the same
per-chunk scans as one device would, and the float32 per-chunk partials
are combined on the host in float64 in global chunk order.  A chunk's
partials depend on its trial ids and its length alone, so a sharded
result equals the one-device result bit for bit on devices of one type.
Launches on different cards from one host thread are asynchronous, so
``issue_order`` interleaves the blocks (chunk 0 of every block, then
chunk 1, ...) to start every device early.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
from typing import List, Optional, Sequence, Tuple

import torch

from .device import resolve_device

__all__ = ["MeshCtx", "current_mesh_ctx", "mesh_context", "shard",
           "axis_size", "placements", "is_dtensor", "seq_write", "gather",
           "unflatten", "matmul_ready", "all_reduce", "reduce_partial",
           "DATA", "MODEL", "BOTH", "TRIAL_AXIS", "trial_devices",
           "chunk_blocks", "issue_order", "device_label", "cli_devices"]

DATA = "__data__"    # resolved to the ctx's (possibly stacked) data axes
MODEL = "__model__"  # resolved to the ctx's model axis
BOTH = "__both__"    # data axes + model axis (a fully sharded dim)

_state = threading.local()


@dataclasses.dataclass
class MeshCtx:
    """A device mesh and the roles of its axes: ``mesh`` is a
    ``DeviceMesh`` (anything with ``mesh_dim_names`` and ``shape`` serves
    the rules of ``launch/shardings.py``); ``model_axis`` None is pure
    data parallelism."""
    mesh: object
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: Optional[str] = "model"
    fallbacks: list = dataclasses.field(default_factory=list)

    @property
    def axis_sizes(self) -> dict:
        return dict(zip(self.mesh.mesh_dim_names, tuple(self.mesh.shape)))

    @property
    def data_size(self) -> int:
        out = 1
        for a in self.data_axes:
            out *= self.axis_sizes[a]
        return out

    @property
    def model_size(self) -> int:
        return self.axis_sizes[self.model_axis] if self.model_axis else 1

    def resolve(self, spec_entry):
        if spec_entry == DATA:
            return (self.data_axes if len(self.data_axes) > 1
                    else self.data_axes[0])
        if spec_entry == MODEL:
            return self.model_axis
        if spec_entry == BOTH:
            if self.model_axis is None:
                return self.resolve(DATA)
            return tuple(self.data_axes) + (self.model_axis,)
        return spec_entry

    def spec(self, *entries) -> tuple:
        """The reference's ``PartitionSpec`` as a tuple of axis names."""
        return tuple(self.resolve(e) for e in entries)


def current_mesh_ctx() -> Optional[MeshCtx]:
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def mesh_context(ctx: Optional[MeshCtx]):
    prev = getattr(_state, "ctx", None)
    _state.ctx = ctx
    try:
        yield ctx
    finally:
        _state.ctx = prev


def axis_size(entry) -> int:
    """Size of a placeholder axis under the current ctx (1 if no mesh)."""
    ctx = current_mesh_ctx()
    if ctx is None:
        return 1
    ax = ctx.resolve(entry)
    if ax is None:
        return 1
    sizes = ctx.axis_sizes
    if isinstance(ax, (tuple, list)):
        n = 1
        for a in ax:
            n *= sizes[a]
        return n
    return sizes[ax]


def placements(ctx: MeshCtx, spec: Sequence) -> list:
    """A spec (one entry a tensor dim: an axis name, a tuple of them, or
    None) as DTensor placements, one a mesh dim: ``Shard(i)`` on each mesh
    axis that names dim i (a tuple shards dim i over its axes, the first
    the major one, as ``PartitionSpec`` does), ``Replicate()`` elsewhere
    and on an axis of size 1."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(ctx.mesh.mesh_dim_names)
    sizes = ctx.axis_sizes
    out = [Replicate() for _ in names]
    for dim, e in enumerate(spec):
        for ax in (() if e is None else (e,) if isinstance(e, str) else e):
            if sizes[ax] > 1:
                out[names.index(ax)] = Shard(dim)
    return out


def is_dtensor(x) -> bool:
    """True for a ``DTensor`` (False, without importing DTensor, while
    nothing has)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its pending sums (a row-parallel product's output)
    reduced, its other placements kept: the all-reduce that ends a
    Megatron sublayer, taken once where the output joins the residual
    stream (GSPMD places it there in the reference), not once by each op
    that reads the sum.  The backward reduces the output gradient's
    pending sums the same way: the residual stream's gradient is itself a
    pending sum (a vocab-parallel head's), which DTensor would otherwise
    hand on as one to the row-parallel product, where it gathers the
    weight and multiplies at full size on every rank.  A bf16 or f16 CUDA
    tensor on a gloo mesh takes ``_ReduceHalf`` (float32 sums, both
    ways); a plain tensor is returned as it is."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    target = [Replicate() if p.is_partial() else p for p in x.placements]
    on = [i for i, p in enumerate(x.placements) if p.is_partial()]
    if _half_on_gloo(x, mesh.get_group(on[0])):
        return _ReduceHalf.apply(x)
    local = x.redistribute(mesh, target).to_local(grad_placements=target)
    return DTensor.from_local(local, mesh, target, run_check=False,
                              shape=x.shape, stride=x.stride())


def _half_on_gloo(t: torch.Tensor, group) -> bool:
    """A bf16 or f16 CUDA tensor on a gloo group: the card's multi-rank
    legs run gloo (NCCL takes no two ranks on one card), whose
    half-precision sums of CUDA tensors the port does not rely on."""
    import torch.distributed as dist
    return (t.is_cuda and t.dtype in (torch.bfloat16, torch.float16)
            and dist.get_backend(group) == "gloo")


def _sum_pending(x):
    """The DTensor ``x`` with every pending sum reduced by ``all_reduce``
    on its local block (float32 for half on gloo), the other placements
    kept; no autograd of its own."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    local = x.to_local()
    for i, p in enumerate(x.placements):
        if p.is_partial():
            local = all_reduce(local, "sum", mesh.get_group(i))
    target = [Replicate() if p.is_partial() else p for p in x.placements]
    return DTensor.from_local(local, mesh, target, run_check=False,
                              shape=x.shape, stride=x.stride())


class _ReduceHalf(torch.autograd.Function):
    """``reduce_partial`` of a half-precision DTensor on a gloo mesh: the
    forward sums the pending sums in float32 (``_sum_pending``); the
    backward sums the gradient's the same way and brings it to the
    output's placements, what DTensor's ``from_local`` and
    ``redistribute`` do for the float32 branch.  ``funcol.all_reduce``
    alone is no such function: torch 2.11 gives it no gradient, and 2.13
    gives it one that ``from_local``'s backward would then reduce a second
    time."""

    @staticmethod
    def forward(ctx, x):
        out = _sum_pending(x)
        ctx.placements = out.placements
        return out

    @staticmethod
    def backward(ctx, g):
        if not is_dtensor(g):
            return g
        if any(p.is_partial() for p in g.placements):
            g = _sum_pending(g)
        if tuple(g.placements) != tuple(ctx.placements):
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """The functional all-reduce (``op`` "sum" / "max") of ``t`` over
    ``group``, waited for.  A bf16 or f16 CUDA tensor on a gloo group is
    reduced in float32 and cast back (``_half_on_gloo``).  The port
    defines no gradient for it: its callers (the ring decode's softmax,
    the expert-parallel MoE's sums) run without autograd, and
    ``reduce_partial`` wraps it in ``_ReduceHalf``."""
    import torch.distributed._functional_collectives as funcol
    half = _half_on_gloo(t, group)
    out = funcol.wait_tensor(funcol.all_reduce(
        t.float() if half else t, op, group))
    return out.to(t.dtype) if half else out


def gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` whole along ``dim``: a ``DTensor`` sharded there is gathered
    on that dim (its other placements kept); anything else is returned as
    it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    dim = dim % x.dim()
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
          for p in x.placements]
    return x if pl == list(x.placements) else \
        x.redistribute(x.device_mesh, pl)


def matmul_ready(x: torch.Tensor, w=None) -> torch.Tensor:
    """``x`` (..., d_in) for ``x @ w``: a ``DTensor`` sharded on a middle
    dim (a cache's sequence) is gathered there, as the product flattens
    the leading dims into one that can keep a shard on its first dim
    alone (torch 2.11's DTensor refuses that view; 2.13 gathers the same
    dims).  Where ``w``'s d_in is sharded (a row-parallel weight) and x is
    whole on that mesh axis, x is cut to the same shard, a local slice:
    DTensor's backward would otherwise take w's gradient x^T g from the
    whole x, a product at full size on every rank."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Shard
    if x.dim() > 2:
        for d in sorted({p.dim for p in x.placements
                         if isinstance(p, Shard)}):
            if 0 < d < x.dim() - 1:
                x = gather(x, d)
    if is_dtensor(w) and w.dim() == 2:
        pl = list(x.placements)
        for i, (pw, px) in enumerate(zip(w.placements, pl)):
            if isinstance(pw, Shard) and pw.dim == 0 and px.is_replicate():
                pl[i] = Shard(x.dim() - 1)
        if pl != list(x.placements):
            x = x.redistribute(x.device_mesh, pl)
    return x


def unflatten(x: torch.Tensor, dim: int, sizes) -> torch.Tensor:
    """``x.unflatten(dim, sizes)`` (heads and head dim, KV heads and
    groups).  A ``DTensor`` whose ``dim`` is sharded over more ranks than
    divide ``sizes[0]`` is gathered on that dim first, the resharding
    GSPMD makes of the same reshape in the reference."""
    if is_dtensor(x):
        from torch.distributed.tensor import Shard
        d = dim % x.dim()
        ranks = 1
        for i, p in enumerate(x.placements):
            if isinstance(p, Shard) and p.dim == d:
                ranks *= x.device_mesh.size(i)
        if sizes[0] % ranks:
            x = gather(x, d)
    return x.unflatten(dim, sizes)


def seq_write(buf: torch.Tensor, new: torch.Tensor, start: int,
              dim: int) -> None:
    """``buf``'s positions [start, start + n) along ``dim`` <- ``new`` (n
    there), in place: a cache write.  A ``DTensor`` buffer is written by
    each rank into its own block, the part of the range it owns, with
    ``new`` brought to the buffer's placements on the other dims: nothing
    of the buffer is gathered, as the reference's
    ``dynamic_update_slice`` of a sharded cache gathers nothing."""
    n = new.shape[dim]
    if not is_dtensor(buf):
        buf.narrow(dim, start, n).copy_(new)
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, pl = buf.device_mesh, buf.placements
    keep = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
            for p in pl]
    if not isinstance(new, DTensor):
        new = DTensor.from_local(new, mesh, [Replicate()] * len(pl),
                                 run_check=False)
    new_l = new.redistribute(mesh, keep).to_local()
    shape, off = compute_local_shape_and_global_offset(buf.shape, mesh, pl)
    lo, hi = max(start, off[dim]), min(start + n, off[dim] + shape[dim])
    if lo < hi:
        buf.to_local().narrow(dim, lo - off[dim], hi - lo).copy_(
            new_l.narrow(dim, lo - start, hi - lo))


def shard(x: torch.Tensor, *entries, note: str = "") -> torch.Tensor:
    """Apply a sharding constraint with divisibility fallback. ``entries``
    use DATA/MODEL placeholders or literal axis names / None."""
    ctx = current_mesh_ctx()
    if ctx is None:
        return x
    resolved = []
    for dim, e in enumerate(entries):
        if e is None:
            resolved.append(None)
            continue
        ax = ctx.resolve(e)
        size = axis_size(e)
        if size <= 1:
            resolved.append(None)
        elif x.shape[dim] % size != 0:
            ctx.fallbacks.append((note or "tensor", dim, x.shape[dim], size))
            resolved.append(None)
        else:
            resolved.append(ax)
    if not is_dtensor(x):
        return x
    target = placements(ctx, resolved)
    if not any(p.is_partial() for p in x.placements):
        return x.redistribute(ctx.mesh, target)
    # A pending sum (a vocab-parallel lookup's masked one, a row-parallel
    # product's): its gradient comes back in the target placements, which
    # DTensor's backward of the redistribution can take to a masked sum
    # where a gradient that is itself a pending sum cannot be.
    from torch.distributed.tensor import DTensor
    local = x.redistribute(ctx.mesh, target).to_local(grad_placements=target)
    return DTensor.from_local(local, ctx.mesh, target, run_check=False,
                              shape=x.shape, stride=x.stride())

TRIAL_AXIS = "trials"


def _canonical(dev: torch.device) -> torch.device:
    """``cuda`` without an index names the current card."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def trial_devices(devices=None) -> Tuple[torch.device, ...]:
    """Resolve the ``devices`` argument of the sweeps, as the JAX package's
    ``trial_devices``: ``None`` means every local CUDA device; an int the
    first that many CUDA devices (``ValueError`` outside ``1..count``); a
    sequence is taken as it is, repeats included (``["cpu"] * 4`` runs
    four blocks on the CPU); a single device name or ``torch.device`` is
    that one device.  A list that mixes the CPU and CUDA is refused, and a
    CUDA device asked for without one raises, as ``resolve_device`` does:
    there is no fallback to the CPU."""
    if devices is None:
        resolve_device(None)
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    if isinstance(devices, bool):
        raise ValueError(f"devices must be None, an int or devices, got "
                         f"{devices!r}")
    if isinstance(devices, int):
        count = torch.cuda.device_count()
        if not 1 <= devices <= count:
            raise ValueError(
                f"devices must be in 1..{count} (local CUDA device count), "
                f"got {devices}; name the devices (e.g. 'cpu') to run "
                f"elsewhere")
        return tuple(torch.device("cuda", i) for i in range(devices))
    if isinstance(devices, (str, torch.device)):
        devices = (devices,)
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("devices must name at least one device")
    kinds = sorted({d.type for d in devs})
    if len(kinds) > 1:
        raise ValueError(f"devices mix device types {kinds}: a sharded "
                         f"sweep is bit-exact only on devices of one type")
    return tuple(_canonical(resolve_device(d)) for d in devs)


def chunk_blocks(n_chunks: int, n_devices: int) -> List[range]:
    """The contiguous block of global chunk indices each device runs: the
    JAX package's layout, ``d_eff = min(n_devices, n_chunks)`` devices,
    the chunk count padded up to a multiple of ``d_eff`` and dealt
    ``nc_pad / d_eff`` a device.  The padded chunks hold no real trial and
    are not run, so the last blocks may be short or empty."""
    d_eff = min(int(n_devices), int(n_chunks))
    per = -(-int(n_chunks) // d_eff)
    return [range(j * per, min((j + 1) * per, n_chunks))
            for j in range(d_eff)]


def issue_order(n_chunks: int, devices: Sequence[torch.device]
                ) -> List[Tuple[int, torch.device]]:
    """``(global chunk index, device)`` pairs in the order they are issued:
    the blocks of ``chunk_blocks`` interleaved, one chunk of each in
    turn."""
    blocks = chunk_blocks(n_chunks, len(devices))
    out = []
    for step in range(max(len(b) for b in blocks)):
        for dev, block in zip(devices, blocks):
            if step < len(block):
                out.append((block[step], dev))
    return out


def device_label(devices: Sequence[torch.device]) -> str:
    """The device list as a run's artifact records it: ``"cpu"`` or
    ``"cuda:0"`` for one device, the names joined by commas for more."""
    return ",".join(str(_canonical(torch.device(d))) for d in devices)


def cli_devices(device: str, count=None):
    """The ``devices`` argument that the CLIs' ``--device`` and
    ``--devices N`` name: the device alone; with a count, the first N cards
    under ``cuda``, else the named device N times (``cpu`` x 4 runs four
    blocks on the CPU)."""
    if count is None:
        return device
    if device == "cuda":
        return int(count)
    return [device] * int(count)
