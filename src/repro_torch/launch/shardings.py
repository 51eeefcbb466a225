"""Rule-based parameter / cache / batch shardings with divisibility fallback
(counterpart of ``repro.launch.shardings``).

Params follow the Megatron tensor-parallel pattern on the ``model`` axis:
column-parallel in-projections, row-parallel out-projections, vocab-parallel
embeddings, expert-parallel MoE weight stacks. Any dim not divisible by the
axis size is left replicated and the fallback is recorded for the roofline
report.

Decode caches: batch on the data axes; KV-head dim on ``model`` when
divisible, else the sequence dim (sequence-parallel cache — how 32k/500k
caches fit when kv-heads < axis size).

A spec is the reference's ``PartitionSpec`` as a tuple (an axis name, a
tuple of names, or None a tensor dim); ``sharding.placements`` turns it
into DTensor placements and ``distribute`` makes the DTensors.  The rules
are keyed on the reference's pytree paths; the port's dotted names map to
them through the correspondence of ``convert._unstack`` (``blocks.<l>.``
is layer l of the segment plan, ``segments/<s>/<j>/`` in the reference),
so one set of rules serves both and the reference's leading None of a
stacked leaf's rep axis falls away.  Fallbacks are recorded with the
reference's path and shape, once a stacked leaf, as the reference's.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..models.model import plan_segments
from ..sharding import MeshCtx, placements

__all__ = ["param_spec", "params_shardings", "zero1_shardings",
           "batch_shardings", "cache_shardings", "cache_leaf_spec",
           "reference_path", "distribute", "distribute_params",
           "distribute_train_state"]


def _div(dim: int, size: int) -> bool:
    return size > 1 and dim % size == 0


def param_spec(path: str, shape: Tuple[int, ...], ctx: MeshCtx,
               fallbacks: Optional[List] = None) -> tuple:
    """Spec for one parameter leaf (local shapes, no leading rep
    axis)."""
    m = ctx.model_axis
    ms = ctx.model_size
    nd = len(shape)
    none = (None,) * nd

    def col(io=-1):
        """shard output (last) dim."""
        if _div(shape[io], ms):
            sp = [None] * nd
            sp[io] = m
            return tuple(sp)
        if fallbacks is not None:
            fallbacks.append((path, shape, "col"))
        return none

    def row(io=0):
        if _div(shape[io], ms):
            sp = [None] * nd
            sp[io] = m
            return tuple(sp)
        if fallbacks is not None:
            fallbacks.append((path, shape, "row"))
        return none

    leaf = path.rsplit("/", 1)[-1]

    if path.endswith("embed") or leaf == "pos_embed":
        return col(0)
    if "lm_head" in path:
        return col(-1) if leaf == "w" else col(0)
    # MoE expert stacks (E, d, f)/(E, f, d): expert-parallel on E
    if nd == 3 and ("w_gate" in path or "w_up" in path or "w_down" in path):
        return row(0)
    if "router" in path:
        return none
    # attention / mla / general projections
    if leaf == "w":
        if any(k in path for k in ("wq/", "wk/", "wv/", "w_uq", "w_uk",
                                   "w_gate", "w_up", "w_k/", "w_r/",
                                   "w_v/", "w_g/", "in_proj", "w_lora_a",
                                   "dt_proj")):
            return col(-1)
        if any(k in path for k in ("wo/", "w_down", "out_proj", "w_o/",
                                   "w_lora_b", "x_proj")):
            return row(0)
        return none
    if leaf == "b":
        if any(k in path for k in ("wq/", "wk/", "wv/", "in_proj",
                                   "dt_proj")):
            return col(0) if nd == 1 else none
        return none
    # mamba internals sharded on d_inner
    if leaf in ("conv_w", "conv_b", "A_log", "D"):
        return col(1) if leaf == "conv_w" else col(0)
    # rwkv head-structured leaves (H, dh)
    if leaf == "u" or "ln_out" in path:
        return row(0)
    return none


def _layer_keys(cfg) -> List[Tuple[int, int, int]]:
    """(segment, position in its period, reps) of each layer, in the
    order ``convert._unstack`` deals them: rep-major, then the
    position."""
    out = []
    for si, seg in enumerate(plan_segments(cfg)):
        for _rep in range(seg.reps):
            for j in range(len(seg.specs)):
                out.append((si, j, seg.reps))
    return out


def reference_path(name: str, cfg) -> str:
    """The reference's pytree path of the port parameter ``name``."""
    parts = name.split(".")
    if parts[0] == "blocks":
        si, j, _reps = _layer_keys(cfg)[int(parts[1])]
        return "/".join(["segments", str(si), str(j)] + parts[2:])
    if parts[:2] == ["encoder", "blocks"]:
        return "/".join(["encoder", "blocks", "0"] + parts[3:])
    return "/".join(parts)


def _record_once(fallbacks: Optional[List], seen: set, new: List) -> None:
    if fallbacks is None:
        return
    for f in new:
        key = (f[0], f[2])
        if key not in seen:
            seen.add(key)
            fallbacks.append(f)


def params_shardings(model: torch.nn.Module, ctx: MeshCtx,
                     fallbacks: Optional[List] = None) -> Dict[str, tuple]:
    """{parameter name: spec} for the port's ``Transformer``."""
    cfg = model.cfg
    out, seen = {}, set()
    for name, p in model.named_parameters():
        path = reference_path(name, cfg)
        new: List = []
        out[name] = param_spec(path, tuple(p.shape), ctx, new)
        _record_once(fallbacks, seen, new)
    return out


def _data_spec_entry(ctx: MeshCtx):
    return ctx.data_axes if len(ctx.data_axes) > 1 else ctx.data_axes[0]


def zero1_shardings(shapes: Dict[str, tuple], base: Dict[str, tuple],
                    ctx: MeshCtx) -> Dict[str, tuple]:
    """ZeRO-1 (§Perf): optimizer-state leaves additionally shard their
    first still-unsharded divisible dim over the DATA axes (the state is
    only touched at the optimizer step, so the gather cost is one
    reduce-scatter/all-gather pair per step — the memory win is
    data_size x).  ``shapes`` and ``base``: {name: shape}, {name: spec}."""
    d = _data_spec_entry(ctx)
    ds = ctx.data_size
    out = {}
    for name, shape in shapes.items():
        spec = list(base[name]) + [None] * (len(shape) - len(base[name]))
        for i, dim in enumerate(shape):
            if spec[i] is None and dim % ds == 0 and dim >= ds:
                spec[i] = d
                break
        else:
            out[name] = base[name]
            continue
        out[name] = tuple(spec)
    return out


def batch_shardings(batch: Dict[str, torch.Tensor], ctx: MeshCtx, *,
                    slot_major: bool = False) -> Dict[str, tuple]:
    """Inputs: shard the batch dim over the data axes. Slot-major straggler
    batches (r, n, b, ...) shard the WORKER dim (axis 1) — the n logical
    workers are the data-parallel shard groups."""
    d = _data_spec_entry(ctx)
    dsize = ctx.data_size

    def one(leaf):
        shape = tuple(leaf.shape)
        if slot_major:
            if len(shape) >= 2 and shape[1] % dsize == 0:
                return (None, d) + (None,) * (len(shape) - 2)
            return (None,) * len(shape)
        if shape and shape[0] % dsize == 0:
            return (d,) + (None,) * (len(shape) - 1)
        return (None,) * len(shape)

    return {k: one(v) for k, v in batch.items()}


def cache_leaf_spec(leafname: str, inner: tuple, ctx: MeshCtx
                     ) -> Tuple[list, bool]:
    """The reference's per-leaf heuristic (repro/launch/shardings.py:
    170-246) on a leaf's unstacked shape: (spec, kv-seq-parallel)."""
    d = _data_spec_entry(ctx)
    dsize, msize = ctx.data_size, ctx.model_size
    m = ctx.model_axis
    spec: list = [None] * len(inner)
    seq_par = False
    B = inner[0]
    b_ok = B % dsize == 0
    if b_ok:
        spec[0] = d
    if leafname in ("k", "v", "xk", "xv") and len(inner) == 4:
        K, S = inner[1], inner[2]
        if K % msize == 0:
            spec[1] = m
        elif S % msize == 0:
            spec[2] = m
            seq_par = True
        if not b_ok and S % (dsize * msize) == 0 and spec[2] is None:
            spec[2] = (d, m) if isinstance(d, str) else tuple(
                list(d if isinstance(d, tuple) else (d,)) + [m])
        elif not b_ok and spec[2] == m and S % (dsize * msize) == 0:
            spec[2] = tuple((list(d) if isinstance(d, tuple) else [d])
                            + [m])
    elif leafname in ("c_kv", "k_rope") and len(inner) == 3:
        S = inner[1]
        if b_ok and S % msize == 0:
            spec[1] = m
        elif not b_ok and S % (dsize * msize) == 0:
            spec[1] = tuple((list(d) if isinstance(d, tuple) else [d])
                            + [m])
        elif S % msize == 0:
            spec[1] = m
    elif leafname == "h" and len(inner) == 3:
        if inner[1] % msize == 0:
            spec[1] = m
    elif leafname == "conv" and len(inner) == 3:
        if inner[2] % msize == 0:
            spec[2] = m
    elif leafname == "S" and len(inner) == 4:
        if inner[1] % msize == 0:
            spec[1] = m
    return spec, seq_par


def cache_shardings(cache: dict, cfg, ctx: MeshCtx,
                    fallbacks: Optional[List] = None) -> dict:
    """Decode caches, a spec for every tensor of the port's cache
    (``init_cache``: {"layers": [...], "pos"}) in its structure, host
    integers and None left out.  The reference's heuristic per leaf kind:
      k/v   (B, K, S, dh): B->data; K->model if divisible else S->model
      c_kv  (B, S, R) / k_rope (B, S, rd): B->data; S->model (if divisible)
      ssm h (B, di, N): B->data, di->model; conv (B, w, di): di->model
      rwkv S (B, H, dh, dh): B->data, H->model
      xk/xv (B, H, T, dh): B->data, H->model
    If B is not divisible by the data size (e.g. batch 1), the sequence dim
    is sharded over (data x model) when possible."""
    keys = _layer_keys(cfg)
    seen: set = set()
    layers = []
    for li, layer in enumerate(cache["layers"]):
        si, j, reps = keys[li]
        specs: dict = {}
        for name, val in layer.items():
            leaves = val.items() if isinstance(val, dict) else [(None, val)]
            sub = {}
            for leafname, t in leaves:
                if not isinstance(t, torch.Tensor):
                    continue
                ln = name if leafname is None else leafname
                inner = tuple(t.shape)
                if not inner:
                    sub[leafname] = ()
                    continue
                spec, seq_par = cache_leaf_spec(ln, inner, ctx)
                if seq_par:
                    path = "/".join(["segments", str(si), str(j), name] +
                                    ([] if leafname is None else [leafname]))
                    _record_once(fallbacks, seen,
                                 [(path, (reps,) + inner,
                                   "kv-seq-parallel")])
                sub[leafname] = tuple(spec)
            if isinstance(val, dict):
                specs[name] = sub
            elif None in sub:
                specs[name] = sub[None]
        layers.append(specs)
    return {"layers": layers}


def distribute(t: torch.Tensor, spec: tuple, ctx: MeshCtx):
    """``t``, the global tensor, as a DTensor of ``spec`` on ``ctx``'s mesh:
    each rank keeps its own block.  On ``meta`` only the local block's
    shape is made; elsewhere the block is cut from ``t``."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    pl = placements(ctx, spec)
    if t.device.type == "meta":
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset
        local, _ = compute_local_shape_and_global_offset(
            t.shape, ctx.mesh, pl)
        return DTensor.from_local(
            torch.empty(local, dtype=t.dtype, device="meta"), ctx.mesh, pl,
            run_check=False, shape=t.shape, stride=t.stride())
    return distribute_tensor(t, ctx.mesh, pl, src_data_rank=None)


def distribute_params(module: torch.nn.Module, specs: Dict[str, tuple],
                      ctx: MeshCtx) -> torch.nn.Module:
    """Each parameter of ``module`` replaced, in place, by a DTensor
    parameter of its spec in ``specs`` (by ``named_parameters`` name), its
    ``requires_grad`` kept."""
    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        setattr(mod, leaf, torch.nn.Parameter(
            distribute(p.detach(), specs[name], ctx),
            requires_grad=p.requires_grad))
    return module


def distribute_train_state(state, ctx: MeshCtx, *, zero1: bool = False,
                           fallbacks: Optional[List] = None
                           ) -> Dict[str, tuple]:
    """A ``train.TrainState`` placed on ``ctx``'s mesh, in place: its
    weights by ``params_shardings`` (``distribute_params``), its optimizer
    moments beside them, or with ``zero1`` also over the data axes
    (``zero1_shardings``).  Returns the weights' specs."""
    specs = params_shardings(state.params, ctx, fallbacks)
    distribute_params(state.params, specs, ctx)
    ospecs = specs
    if zero1:
        ospecs = zero1_shardings({k: tuple(p.shape) for k, p in
                                  state.params.named_parameters()},
                                 specs, ctx)
    for m, tree in state.opt_state.items():
        if isinstance(tree, dict):
            state.opt_state[m] = {k: distribute(v, ospecs[k], ctx)
                                  for k, v in tree.items()}
    return specs
