"""Dry run with H100 roofline terms, on one card or a mesh of cards
(counterpart of ``repro.launch.dryrun``).

For one (architecture x input shape x mesh):
  * builds the step (straggler train round / prefill / decode) with its
    model, optimizer state, KV cache and inputs on the ``meta`` device:
    shapes and dtypes only, nothing allocated (``build_train``,
    ``build_prefill``, ``build_decode``);
  * on one card ("1xH100") runs the step once under ``FlopCounterMode``
    (``flops_per_device``: every matmul, and ``swa_attention`` by its
    registered formula, the band) and once under ``TrafficMode``
    (``bytes_per_device``: what every op reads and writes, ``op_bytes``,
    the analogue of XLA's "bytes accessed"; the peak of live bytes the
    step allocates, ``memory_analysis.temp_size_in_bytes``, beside the
    bytes of its arguments);
  * on a mesh ("16x16", "2x16x16" with ``--multi-pod``, or a local
    "DxM") shards the weights, caches, optimizer state and inputs by
    ``launch/shardings.py`` as DTensors over the fake process group
    (``launch/mesh.py``: 256 or 512 ranks in one process, collectives
    that move nothing), runs the step under the model's ``shard``
    constraints, and counts what rank 0 runs (``MeshTrafficMode``):
    FLOPs, bytes and the peak of the local blocks, and the collectives
    by kind (``collectives``: bytes of each result and counts, the
    reference's ``collective_bytes`` schema), all per device;
  * derives the roofline terms from an H100 SXM's published peaks (989e12
    dense bf16 FLOP/s on the tensor cores, 3.35e12 B/s of HBM, and for
    the collectives ``LINK_BW``, InfiniBand's 50 GB/s a card) and the
    useful share MODEL_FLOPS / counted FLOPs.

The count is exact ("meta-exact"): every layer and every step of the SSM
time loops runs on ``meta``, where the reference compiles two probe depths
and extrapolates, and counts an SSM time scan's body once.  A decode step
runs at cache position seq_len - 1, the deepest the shape allows (MLA's
naive path decompresses the latents of [0, pos + 1), so its cost grows with
the position; the reference's compiled step costs the same at any depth).
The collectives are DTensor's for the port's shardings (a reduce-scatter
and an all-gather where XLA may choose one all-reduce), on a ``cuda`` mesh
as NCCL would run them.  Variants: ``absorb`` and ``grouped`` change the
config and run on one card too; ``zero1`` (optimizer state sharded over
the data axes), ``batchshard``, ``puredp`` (the model axis folded into the
data axes) and ``ringdecode`` need a mesh, and take the 16x16 one unless
``--mesh`` names another.  ``fits`` says whether the argument and temp
bytes fit one card's 80 GB.  The one-card builds run on a card too
(``device="cuda"``: weights from ``seed``, zero caches, zero tokens,
normal extras), which is how ``chip_smoke.py`` holds the count to a real
step.  A mesh starts a process group, global state: run it in a process
of its own (``--all`` starts one a combo).

Usage (no card needed):
  python -m repro_torch.launch.dryrun --arch gemma3-4b --shape long_500k
  python -m repro_torch.launch.dryrun --arch mistral-nemo-12b \
      --shape decode_32k --mesh 16x16 --variant ringdecode
  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k \
      --multi-pod --variant zero1
  python -m repro_torch.launch.dryrun --all [--mesh 16x16]  # a process each
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils import flop_counter
from torch.utils.flop_counter import FlopCounterMode

from ..configs import (ARCH_IDS, SHAPES, get_config, input_specs, resolve,
                       shape_supported)
from ..core import RoundConfig, scenario1
from ..models import active_params, init_cache, init_params
from ..models.model import forward
from ..optim import adamw
from ..sharding import MeshCtx, gather, is_dtensor, mesh_context
from ..train import init_train_state, make_serve_step, \
    make_straggler_train_step

__all__ = ["VARIANTS", "MESH_VARIANTS", "PEAK_FLOPS", "HBM_BW", "NVLINK_BW",
           "IB_BW", "LINK_BW", "CARD_BYTES", "COLLECTIVE_KINDS",
           "TrafficMode", "MeshTrafficMode", "op_bytes", "build_train",
           "build_prefill", "build_decode", "build", "measure", "make_ctx",
           "default_mesh", "dryrun_config", "model_flops_global", "run_one",
           "artifact_name", "main"]

VARIANTS = ("zero1", "absorb", "grouped", "batchshard", "puredp",
            "ringdecode")
#: the variants that need a mesh of cards
MESH_VARIANTS = ("zero1", "batchshard", "puredp", "ringdecode")

# --- H100 SXM published peaks (per card, NVIDIA data sheet) ---------------
PEAK_FLOPS = 989e12          # dense bf16 on the tensor cores
HBM_BW = 3.35e12             # bytes/s
# --- interconnect, per card and direction ---------------------------------
#: NVLink 4 inside an 8-card HGX H100 node: 900 GB/s a card both ways
#: (NVIDIA H100 data sheet), 450 GB/s a direction
NVLINK_BW = 450e9
#: NDR InfiniBand between nodes: one 400 Gb/s ConnectX-7 port a card
#: (NVIDIA DGX H100 user guide), 50 GB/s a direction
IB_BW = 50e9
#: the collective term's link: a 16-wide model axis spans two 8-card
#: nodes and the data axes stride across nodes, so every collective of
#: the 16x16 and 2x16x16 meshes has a ring hop over InfiniBand, the
#: slowest link, which sets a ring's rate
LINK_BW = IB_BW
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")
#: the functional collectives DTensor and the model issue, by kind
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all"}
#: functional-collective ops that move nothing
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")
#: one card's memory, for ``fits``
CARD_BYTES = 80e9
#: the data-parallel width of the reference's pod mesh, the straggler
#: round's n (a (16, 16) mesh's data axis)
ROUND_N = 16


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _writes(spec) -> bool:
    return spec.alias_info is not None and spec.alias_info.is_write


def op_bytes(func, args, kwargs, out) -> int:
    """The bytes an op moves: its tensor inputs read and its outputs
    written.  A view, or an op that returns its input as it is (``to`` to
    its own dtype), moves nothing.  An in-place op reads its other inputs
    and writes, of its target, as many elements as its largest other
    input holds (a cache write, ``index_put_``, writes its values, not the
    cache), or all of it when it has no other tensor input."""
    if func.is_view:
        return 0
    kwargs = kwargs or {}
    specs = func._schema.arguments
    mutated = [a for spec, a in zip(specs, args) if _writes(spec)]
    mutated += [kwargs[spec.name] for spec in specs
                if spec.name in kwargs and _writes(spec)]
    written = {id(t) for t in _tensors(mutated)}
    ins = _tensors((args, kwargs))
    reads = [t for t in ins if id(t) not in written]
    if not written:
        outs = _tensors(out)
        if outs and {_storage(t) for t in outs} <= {_storage(t) for t in ins}:
            return 0
        return sum(_nbytes(t) for t in reads + outs)
    most = max((t.numel() for t in reads), default=None)
    return sum(_nbytes(t) for t in reads) + sum(
        (_nbytes(t) if most is None else
         min(t.numel(), most) * t.element_size())
        for t in ins if id(t) in written)


class TrafficMode(TorchDispatchMode):
    """Counts, over the ops dispatched under it: ``bytes``, what each op
    moves (``op_bytes``); ``peak``, the most bytes alive at once in
    storages that ops created (each storage counted from its creation
    until it is freed, through ``weakref.finalize``), storages of
    ``known`` tensors (the step's arguments) excluded; ``live``, those
    bytes alive now; ``ops``, the ops dispatched."""

    def __init__(self, known=()):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.ops = 0
        self._seen = {_storage(t) for t in known}

    def _free(self, key, n):
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        self.bytes += op_bytes(func, args, kwargs, out)
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            self._seen.add(key)
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)
        return out


def _collective_kind(func):
    """The kind of a functional collective (None for any other op); one
    the table does not know raises, so none goes uncounted."""
    if func.namespace not in ("_c10d_functional", "_dtensor"):
        return None
    name = func._overloadpacket.__name__
    if name in _NOT_COLLECTIVES:
        return None
    if name not in _COLLECTIVE_OPS:
        raise NotImplementedError(f"dry run: collective {func} has no kind")
    return _COLLECTIVE_OPS[name]


class MeshTrafficMode(TrafficMode):
    """``TrafficMode`` for a step on DTensors, counting what this rank
    runs: an op on DTensors is handed back to DTensor (``NotImplemented``),
    which runs its local ops and collectives on the blocks with this mode
    still on the stack, so shapes are local; the ops DTensor runs on fake
    tensors (a fake mode active) to propagate global shapes are not
    counted.
    Also counts ``flops`` (``torch.utils.flop_counter``'s formulas, the
    ones ``FlopCounterMode`` applies) and the collectives' result bytes
    and counts by kind (``coll``, ``coll_counts``)."""

    def __init__(self, known=()):
        super().__init__(known)
        self.flops = 0
        self.coll = dict.fromkeys(COLLECTIVE_KINDS, 0)
        self.coll_counts = dict.fromkeys(COLLECTIVE_KINDS, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(is_dtensor(t) for t in tree_flatten((args, kwargs))[0]):
            return NotImplemented
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE):
            return func(*args, **kwargs)     # DTensor's shape propagation
        if func._overloadpacket.__name__ in _NOT_COLLECTIVES and \
                func.namespace == "_c10d_functional":
            return func(*args, **kwargs)     # a wait or a wrapper: no data
        out = super().__torch_dispatch__(func, types, args, kwargs)
        formula = flop_counter.flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        kind = _collective_kind(func)
        if kind:
            self.coll[kind] += sum(_nbytes(t) for t in _tensors(out))
            self.coll_counts[kind] += 1
        return out


def _local(t):
    return t.to_local() if is_dtensor(t) else t


def _inputs(cfg, shape: str, device, seed: int, **kw) -> dict:
    """``input_specs`` on ``device``; off ``meta`` with values: token ids
    0, float extras normal under ``seed``."""
    ins = input_specs(cfg, shape, device=device, **kw)
    if torch.device(device).type != "meta":
        gen = torch.Generator(device=device).manual_seed(seed)
        for t in ins.values():
            if t.is_floating_point():
                t.normal_(generator=gen)
            else:
                t.zero_()
    return ins


def _check_variant(variant: str) -> dict:
    """The config overrides of a comma list of ``VARIANTS`` (``zero1`` and
    ``puredp`` change the shardings, not the config)."""
    overrides = {}
    for v in filter(None, variant.split(",")):
        if v == "absorb":
            overrides["mla_absorb"] = True
        elif v == "grouped":
            overrides["grouped_gqa"] = True
        elif v == "batchshard":
            overrides["attn_batch_shard_fallback"] = True
        elif v == "ringdecode":
            overrides["seq_shard_decode"] = True
        elif v not in VARIANTS:
            raise ValueError(f"unknown variant {v!r}; have {VARIANTS}")
    return overrides


def _mesh_shape(mesh: str) -> tuple:
    """"16x16" -> (16, 16); "1xH100" -> ()."""
    if mesh == "1xH100":
        return ()
    try:
        shape = tuple(int(a) for a in mesh.split("x"))
    except ValueError:
        raise ValueError(f"unknown mesh {mesh!r}: 1xH100, 16x16, 2x16x16 "
                         f"or DxM") from None
    if len(shape) not in (2, 3) or min(shape) < 1:
        raise ValueError(f"unknown mesh {mesh!r}: 1xH100, 16x16, 2x16x16 "
                         f"or DxM")
    return shape


def make_ctx(mesh: str, variant: str = "") -> MeshCtx | None:
    """The mesh context of ``mesh`` ("16x16", "2x16x16": the reference's
    pod and multi-pod meshes; "DxM": a local (data, model) mesh) on a
    ``cuda`` mesh over the fake process group, which this starts; None for
    "1xH100".  ``puredp`` folds the model axis into the data axes."""
    from . import mesh as mesh_mod
    shape = _mesh_shape(mesh)
    if not shape:
        return None
    n = 1
    for a in shape:
        n *= a
    mesh_mod.fake_process_group(n)
    if mesh in ("16x16", "2x16x16"):
        ctx = mesh_mod.make_mesh_ctx(multi_pod=mesh == "2x16x16")
    elif len(shape) == 2:
        ctx = mesh_mod.make_local_mesh_ctx(*shape)
    else:
        raise ValueError(f"a three-axis mesh is 2x16x16 only, got {mesh}")
    if "puredp" in variant.split(","):
        # tiny-model deployment choice: no tensor-parallel axis — the
        # whole mesh becomes data parallelism (params replicated)
        ctx = MeshCtx(mesh=ctx.mesh,
                      data_axes=tuple(ctx.data_axes) + (ctx.model_axis,),
                      model_axis=None)
    return ctx


def _shard_params(model, ctx: MeshCtx, fallbacks: list) -> dict:
    """Each parameter of ``model`` replaced by a DTensor parameter of its
    spec (``params_shardings``); returns the specs."""
    from .shardings import distribute_params, params_shardings
    specs = params_shardings(model, ctx, fallbacks)
    distribute_params(model, specs, ctx)
    return specs


def _shard_dict(tree: dict, specs: dict, ctx: MeshCtx) -> dict:
    from .shardings import distribute
    return {k: distribute(v, specs[k], ctx) if k in specs else v
            for k, v in tree.items()}


def _in_ctx(ctx: MeshCtx | None, grad: bool = False):
    """The context a step runs in: none on one card; on a mesh the mesh
    context, plain tensors taken as replicated, and no autograd unless
    ``grad`` (an inference tensor cannot be written into a DTensor's
    block, so a mesh decode runs under ``no_grad``)."""
    from torch.distributed.tensor.experimental import implicit_replication
    stack = contextlib.ExitStack()
    stack.enter_context(mesh_context(ctx))
    stack.enter_context(implicit_replication())
    if not grad:
        stack.enter_context(torch.no_grad())
    return stack


def build_train(cfg, shape: str, *, r: int = 1, k_frac: float = 1.0,
                schedule: str = "ss", n: int | None = None, device="meta",
                seed: int = 0, ctx: MeshCtx | None = None,
                zero1: bool = False):
    """The straggler train round of ``shape`` (AdamW 1e-4, scenario 1's
    delays, n workers, k = round(k_frac n); n is the data size of ``ctx``,
    else ``ROUND_N``): (step, arguments, meta).  On a mesh the weights,
    the AdamW moments (``zero1``: also over the data axes) and the
    slot-major tokens are sharded."""
    n = n or (ctx.data_size if ctx is not None else ROUND_N)
    k = max(1, int(round(k_frac * n)))
    config = RoundConfig(n=n, k=k, kind=schedule, r=r)
    opt = adamw(1e-4)
    step = make_straggler_train_step(cfg, opt, config, scenario1())
    state = init_train_state(cfg, opt, seed=seed, device=device)
    ins = _inputs(cfg, shape, device, seed, n=n, r=r)
    meta = {"round": dict(n=n, r=r, k=k, schedule=schedule)}
    if ctx is not None:
        from .shardings import batch_shardings, distribute_train_state
        fallbacks: list = []
        distribute_train_state(state, ctx, zero1=zero1, fallbacks=fallbacks)
        ins = _shard_dict(ins, batch_shardings(ins, ctx, slot_major=True),
                          ctx)
        meta["fallbacks"] = [str(f) for f in fallbacks]
    extras = {}
    if "slot_embeds" in ins:
        extras["embeds"] = ins["slot_embeds"]
    if "slot_frames" in ins:
        extras["enc_frames"] = ins["slot_frames"]

    def fn():
        with (_in_ctx(ctx, grad=True) if ctx is not None
              else contextlib.nullcontext()):
            new_state, metrics, _cluster = step(
                state, ins["slot_tokens"], ins["slot_labels"], seed,
                extras=extras or None)
        return new_state, metrics

    args = (state.named_params(), state.opt_state, ins)
    return fn, args, meta


def build_prefill(cfg, shape: str, *, device="meta", seed: int = 0,
                  ctx: MeshCtx | None = None):
    """The prefill of ``shape``: the forward without a cache and the argmax
    of the last position's logits (over the whole vocabulary, gathered
    under a mesh)."""
    params = init_params(cfg, seed=seed, device=device)
    ins = _inputs(cfg, shape, device, seed)
    meta = {}
    if ctx is not None:
        from .shardings import batch_shardings
        fallbacks: list = []
        _shard_params(params, ctx, fallbacks)
        ins = _shard_dict(ins, batch_shardings(ins, ctx), ctx)
        meta["fallbacks"] = [str(f) for f in fallbacks]

    def fn():
        with _in_ctx(ctx) if ctx is not None else torch.inference_mode():
            logits, _, _ = forward(params, cfg, ins["tokens"],
                                   embeds=ins.get("embeds"),
                                   enc_frames=ins.get("enc_frames"))
            return gather(logits[:, -1], -1).argmax(dim=-1)

    return fn, (dict(params.named_parameters()), ins), meta


def build_decode(cfg, shape: str, *, device="meta", seed: int = 0,
                 ctx: MeshCtx | None = None):
    """One greedy decode step of ``shape``: B tokens against a cache of
    seq_len positions, at position seq_len - 1 (the cache's ``pos``); a
    decoder with cross-attention reads the encoder's keys and values from
    the cache, as after a prefill.  On a mesh the cache is sharded by
    ``cache_shardings``."""
    sh = SHAPES[shape]
    B, S = sh.global_batch, sh.seq_len
    params = init_params(cfg, seed=seed, device=device)
    cache = init_cache(cfg, B, S, device=device)
    cache["pos"] = S - 1
    for layer in cache["layers"]:
        if "attn" in layer:               # each attention layer's own pos
            layer["attn"]["pos"] = S - 1
        if "xk" in layer:   # the encoder's keys and values a prefill left
            layer["xk"], layer["xv"] = (torch.zeros(
                (B, cfg.n_heads, cfg.encoder_seq, cfg.head_dim),
                dtype=getattr(torch, cfg.dtype), device=device)
                for _ in range(2))
    ins = _inputs(cfg, shape, device, seed)
    meta = {"decode_pos": S - 1}
    if ctx is not None:
        from .shardings import batch_shardings, cache_shardings
        fallbacks: list = []
        _shard_params(params, ctx, fallbacks)
        cspecs = cache_shardings(cache, cfg, ctx, fallbacks)
        for layer, lspecs in zip(cache["layers"], cspecs["layers"]):
            for name, sp in lspecs.items():
                layer[name] = (_shard_dict(layer[name], sp, ctx)
                               if isinstance(sp, dict) else
                               _shard_dict({name: layer[name]},
                                           {name: sp}, ctx)[name])
        ins = _shard_dict(ins, batch_shardings(ins, ctx), ctx)
        meta["fallbacks"] = [str(f) for f in fallbacks]
    serve = make_serve_step(cfg)

    def fn():
        with _in_ctx(ctx) if ctx is not None else torch.inference_mode():
            return serve(params, cache, ins["tokens"])

    return fn, (dict(params.named_parameters()), cache, ins), meta


def build(cfg, shape: str, *, device="meta", r: int = 1,
          k_frac: float = 1.0, schedule: str = "ss", seed: int = 0,
          ctx: MeshCtx | None = None, zero1: bool = False):
    """The build of ``shape``'s kind: (step, arguments, meta)."""
    kind = SHAPES[shape].kind
    if kind == "train":
        return build_train(cfg, shape, r=r, k_frac=k_frac,
                           schedule=schedule, device=device, seed=seed,
                           ctx=ctx, zero1=zero1)
    if zero1:
        raise ValueError("zero1 shards the optimizer state: a train shape")
    if kind == "prefill":
        return build_prefill(cfg, shape, device=device, seed=seed, ctx=ctx)
    return build_decode(cfg, shape, device=device, seed=seed, ctx=ctx)


def measure(fn, args, ctx: MeshCtx | None = None) -> dict:
    """On one card, two calls of ``fn``: one under ``FlopCounterMode`` for
    the FLOPs, one under ``TrafficMode`` alone for the bytes, the ops and
    the bytes of the arguments, of what the step allocated at its peak and
    of what it leaves alive (its outputs).  The peak needs a call of its
    own: ``FlopCounterMode``'s module tracker hangs backward hooks on a
    training step's activations and keeps them alive (gemma3-4b's train_4k
    round peaks at 9 882 GB under it, 3 508 GB without it, by
    ``benchmarks_torch/dryrun_breakdown.py``).  On a mesh (``ctx``), one
    call under ``MeshTrafficMode``, which has no module tracker, for all
    of it and the collectives, per device (the arguments' local
    blocks)."""
    known = [_local(t) for t in _tensors(args)]
    arg_bytes = sum(st.nbytes() for st in
                    {_storage(t): t.untyped_storage()
                     for t in known}.values())
    coll = None
    if ctx is None:
        counter = FlopCounterMode(display=False)
        with counter:
            out = fn()
        del out
        flops = counter.get_total_flops()
        traffic = TrafficMode(known)
    else:
        traffic = MeshTrafficMode(known)
    with traffic:
        out = fn()
    live = traffic.live             # what the step returns, still held
    del out
    if ctx is not None:
        flops = traffic.flops
        coll = {"bytes": dict(traffic.coll),
                "counts": dict(traffic.coll_counts),
                "total_bytes": int(sum(traffic.coll.values()))}
    return {"flops": float(flops),
            "bytes": float(traffic.bytes), "ops": traffic.ops, "coll": coll,
            "mem": {"argument_size_in_bytes": int(arg_bytes),
                    "output_size_in_bytes": int(live),
                    "temp_size_in_bytes": int(traffic.peak),
                    "generated_code_size_in_bytes": 0}}


def model_flops_global(cfg, shape: str, *, r: int = 1) -> float:
    """Useful MODEL_FLOPS for the step: 6*N_active*D train (x r redundancy
    excluded — that's the *useful* figure), 2*N*D prefill, 2*N*B decode."""
    sh = SHAPES[shape]
    N = active_params(cfg)
    if sh.kind == "train":
        return 6.0 * N * sh.global_batch * sh.seq_len
    if sh.kind == "prefill":
        return 2.0 * N * sh.global_batch * sh.seq_len
    return 2.0 * N * sh.global_batch


def _card() -> str | None:
    """The card's name and power limit as nvidia-smi gives them, or None
    without a card."""
    if not torch.cuda.is_available():
        return None
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=60)
        return smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0)


_PREFIX = {"1xH100": "h100", "16x16": "pod", "2x16x16": "multipod"}


def artifact_name(out_dir: str, arch: str, shape: str, tag: str = "",
                  mesh: str = "1xH100") -> str:
    """``<out_dir>/<mesh word>__<arch>__<shape>[__<tag>].json``: the
    reference's layout, its readers' globs take it.  The mesh word is
    "h100" for one card, the reference's "pod" / "multipod" for 16x16 /
    2x16x16, "mesh<D>x<M>" for a local mesh."""
    suffix = f"__{tag}" if tag else ""
    word = _PREFIX.get(mesh, f"mesh{mesh}")
    return os.path.join(out_dir, f"{word}__{arch}__{shape}{suffix}.json")


def default_mesh(variant: str = "", multi_pod: bool = False) -> str:
    """The mesh a run takes unless told: 2x16x16 with ``multi_pod``, the
    16x16 pod for a variant that needs a mesh, else one card."""
    if multi_pod:
        return "2x16x16"
    if set(filter(None, variant.split(","))) & set(MESH_VARIANTS):
        return "16x16"
    return "1xH100"


def dryrun_config(cfg, shape: str, variant: str = ""):
    """The config the dry run of (``cfg``'s arch, ``shape``) traces:
    ``resolve``'s, with remat in training and ``variant``'s overrides."""
    return dataclasses.replace(resolve(cfg, shape), scan_layers=False,
                               remat=SHAPES[shape].kind == "train",
                               **_check_variant(variant))


def run_one(arch: str, shape: str, *, r: int = 1, k_frac: float = 1.0,
            schedule: str = "ss", out_dir: str = "experiments/dryrun_torch",
            tag: str = "", variant: str = "", mesh: str | None = None
            ) -> dict:
    """The dry run of (arch, shape) on ``meta`` on ``mesh`` (default:
    ``default_mesh``); writes its JSON artifact into ``out_dir`` (none when
    empty) and returns it.  A mesh starts the fake process group: one
    mesh a process."""
    t0 = time.perf_counter()
    cfg0 = get_config(arch)
    if not shape_supported(cfg0, shape):
        return {"arch": arch, "shape": shape, "skipped": True,
                "reason": "whisper-base skips long_500k"}
    kind = SHAPES[shape].kind
    cfg = dryrun_config(cfg0, shape, variant)
    mesh = mesh or default_mesh(variant)
    variants = set(filter(None, variant.split(",")))
    if variants & set(MESH_VARIANTS) and mesh == "1xH100":
        raise ValueError(f"variant {variant!r} needs a mesh, not 1xH100")
    zero1 = "zero1" in variants
    if zero1 and kind != "train":
        raise ValueError("zero1 shards the optimizer state: a train shape")
    ctx = make_ctx(mesh, variant)
    n_dev = 1 if ctx is None else ctx.mesh.size()
    fn, args, meta = build(cfg, shape, r=r, k_frac=k_frac,
                           schedule=schedule, ctx=ctx, zero1=zero1)
    t_build = time.perf_counter() - t0
    res = measure(fn, args, ctx)
    t_trace = time.perf_counter() - t0 - t_build
    flops, bytes_acc, mem = res["flops"], res["bytes"], res["mem"]
    meta["accounting"] = "meta-exact"
    meta["meta_ops"] = res["ops"]
    if ctx is not None:
        meta["shard_fallbacks"] = sorted({str(f) for f in ctx.fallbacks})
        meta["link"] = (f"LINK_BW {LINK_BW:.3g} B/s: NDR InfiniBand, the "
                        f"slowest hop of every collective on this mesh")
    if kind == "decode":
        meta["decode"] = (f"one step at cache pos {meta['decode_pos']} "
                          f"(seq_len - 1, the deepest step)")
    coll = res["coll"] or {
        "bytes": dict.fromkeys(COLLECTIVE_KINDS, 0),
        "counts": dict.fromkeys(COLLECTIVE_KINDS, 0), "total_bytes": 0}
    terms = {"compute_s": flops / PEAK_FLOPS, "memory_s": bytes_acc / HBM_BW,
             "collective_s": coll["total_bytes"] / LINK_BW}
    dominant = max(terms, key=terms.get)
    mf = model_flops_global(cfg, shape, r=r)
    mf_dev = mf / n_dev
    need = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    if variant and not tag:
        tag = variant.replace(",", "+")
    result = {
        "arch": arch, "shape": shape, "mesh": mesh, "n_devices": n_dev,
        "kind": kind, "variant": variant or "baseline",
        "round_r": r, "round_k_frac": k_frac,
        "config_name": cfg.name,
        "active_params": active_params(cfg),
        "flops_per_device": flops,
        "bytes_per_device": bytes_acc,
        "collectives": coll,
        "memory_analysis": mem,
        "roofline": {**terms, "dominant": dominant,
                     "model_flops_global": mf,
                     "model_flops_per_device": mf_dev,
                     "useful_ratio": (mf_dev / flops) if flops else 0.0},
        "meta": meta,
        # the reference's keys: the build (no lowering) and the meta trace
        "timings": {"lower_s": t_build, "compile_s": t_trace},
        "fits": need <= CARD_BYTES,
        "device": _card(),
        "wall_s": time.perf_counter() - t0,
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = artifact_name(out_dir, arch, shape, tag, mesh)
        with open(fname, "w") as f:
            json.dump(result, f, indent=1)
        result["file"] = fname
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 mesh (pod, data, model)")
    ap.add_argument("--mesh", default=None,
                    help="1xH100, 16x16, 2x16x16 or DxM (default: 16x16 "
                         "for a variant that needs a mesh, else 1xH100)")
    ap.add_argument("--all", action="store_true",
                    help="run every supported combo in subprocesses")
    ap.add_argument("--r", type=int, default=1, help="computation load")
    ap.add_argument("--k-frac", type=float, default=1.0,
                    help="computation target as fraction of n")
    ap.add_argument("--schedule", default="ss")
    ap.add_argument("--variant", default="",
                    help="comma list of " + ",".join(VARIANTS))
    ap.add_argument("--tag", default="")
    ap.add_argument("--out-dir", default="experiments/dryrun_torch")
    ap.add_argument("--timeout", type=int, default=3000)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    if args.multi_pod and args.mesh not in (None, "2x16x16"):
        ap.error("--multi-pod is the 2x16x16 mesh")
    mesh = args.mesh or default_mesh(args.variant, args.multi_pod)

    if args.all:
        failures, walls = [], {}
        for arch in ARCH_IDS:
            for shape in SHAPES:
                if not shape_supported(get_config(arch), shape):
                    print(f"SKIP {arch} {shape} (whisper-base long_500k)")
                    continue
                fname = artifact_name(args.out_dir, arch, shape, args.tag,
                                      mesh)
                if args.skip_existing and os.path.exists(fname):
                    print(f"EXISTS {fname}")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape,
                       "--r", str(args.r), "--k-frac", str(args.k_frac),
                       "--schedule", args.schedule,
                       "--out-dir", args.out_dir, "--mesh", mesh]
                if args.variant:
                    cmd += ["--variant", args.variant]
                if args.tag:
                    cmd += ["--tag", args.tag]
                print(f"=== {arch} {shape} {mesh} ===", flush=True)
                t0 = time.perf_counter()
                try:
                    rc = subprocess.run(cmd, timeout=args.timeout,
                                        stdout=subprocess.DEVNULL
                                        ).returncode
                except subprocess.TimeoutExpired:
                    rc = "timeout"
                walls[f"{arch} {shape}"] = time.perf_counter() - t0
                print(f"    {walls[f'{arch} {shape}']:.1f} s, rc {rc}",
                      flush=True)
                if rc != 0:
                    failures.append((arch, shape))
        if failures:
            print("FAILURES:", failures)
            sys.exit(1)
        print("ALL DRY-RUNS PASSED")
        return walls

    if not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    res = run_one(args.arch, args.shape, r=args.r, k_frac=args.k_frac,
                  schedule=args.schedule, out_dir=args.out_dir, tag=args.tag,
                  variant=args.variant, mesh=mesh)
    print(json.dumps({k: res[k] for k in res if k != "meta"}, indent=1,
                     default=str))
    return res


if __name__ == "__main__":
    main()
