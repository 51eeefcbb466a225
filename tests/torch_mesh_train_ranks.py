"""Multi-rank checks of training under the port's mesh, over gloo on the
CPU, for ``tests/test_torch_mesh_train.py``: ``main(out)`` spawns 4 ranks
on one thread each, builds a 1 x 2 mesh of ranks 0 and 1 and a 2 x 2 mesh
of all four, and writes what the ranks saw as JSON.

* ``moe_grad_case``: the expert-parallel ``moe_apply`` (8 experts, top 2,
  capacity 1, a shared expert; ``torch_mesh_ranks.MOE``) under autograd,
  the objective sum(out * w) + ``AUX_W`` x aux.  The gradients of the
  router, the expert stacks, the shared expert and the input against the
  same objective on one device with the reference's mesh semantics
  (``mesh_semantics``): capacity, routing and aux per data shard, the aux
  summed over every axis over the data size (model_size x the mean of
  the shards' aux).  Largest gap over the largest one-device value, per
  tensor.
* ``remat_case``: a recomputed (``remat``) block's backward outside the
  mesh context, as on a card, against the same without ``remat``.
* ``train_run``: ``TRAIN_STEPS`` straggler AdamW steps (eps 1e-5) of a
  family's smoke config in float32 on a mesh (state placed by
  ``shardings.distribute_train_state``, ZeRO-1 on 2 x 2; the slot-major
  batches and extras by ``batch_shardings``) against the same steps on one device
  under ``mesh_semantics``: each step's loss and grad norm, every
  parameter's gradient at step 1 and every weight after the last step.
  The one-device runs are made by ranks 2 and 3 while ranks 0 and 1 run
  the 1 x 2 mesh, and handed to rank 0, which takes the gaps.  Beside
  each, the one-device run from weights perturbed at float32 rounding
  (``PERTURB_SEED``): how far rounding alone moves each gradient.

``main_dry(out)`` (``--dry``) runs ``moe_dry``: the MoE layer's train
step on a 1 x 2 mesh on ``meta`` over the fake process group (a process
of its own), its collectives by kind in the forward, the backward and
the reading of the gradients at their weights' placements.
"""
from __future__ import annotations

import contextlib
import json
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.core import RoundConfig, ec2_cluster
from repro_torch.data import TaskPartition, lm_task_batches
from repro_torch.launch import shardings as S
from repro_torch.launch.mesh import make_local_mesh_ctx
from repro_torch.models import layers as L
from repro_torch.optim import adamw
from repro_torch.sharding import mesh_context
from repro_torch.train import init_train_state, make_straggler_train_step
from repro_torch.train import steps as train_steps
from torch_mesh_ranks import MESHES, MOE, _free_port, _moe_specs, _whole

AUX_W = 0.5
B, T = 4, 6
#: (family, mesh world): the 1 x 2 mesh for every family, 2 x 2 for the
#: MoE ones
FAMILIES = ("deepseek-v3-671b", "llama4-maverick-400b-a17b",
            "jamba-v0.1-52b", "rwkv6-1.6b", "gemma3-4b", "whisper-base",
            "llava-next-34b")
MOE_FAMILIES = FAMILIES[:3]
TRAIN_CASES = [(a, 2) for a in FAMILIES] + [(a, 4) for a in MOE_FAMILIES]
TRAIN_STEPS = 2
TRAIN_EPS = 1e-5
TRAIN_LR = 1e-3
#: 4 workers (2 a data rank on 2 x 2), r = 2, 2 sequences of 16 tokens a
#: worker and slot
TRAIN_ROUND = dict(n=4, k=3, kind="ss", r=2)
TRAIN_TOKENS = dict(global_batch=8, seq_len=16)
PERTURB_SEED = 1


@contextlib.contextmanager
def mesh_semantics(data_size: int, model_size: int):
    """One device's ``moe_local`` as the reference's expert-parallel
    ``shard_map`` computes it on a data_size x model_size mesh: the tokens
    cut into data_size contiguous shards (the rows each data rank holds),
    each shard routed with its own capacity, the outputs joined, the aux
    model_size x the mean of the shards' (``lax.psum`` of each model
    rank's whole estimate over every axis, over the data size).  Also
    ``chip_smoke.py``'s, on its 1 x 2 mesh."""
    real = L.moe_local

    def per_shard(x2d, *args, **kw):
        outs, auxs = zip(*(real(xs, *args, **kw)
                           for xs in x2d.chunk(data_size)))
        return torch.cat(outs), model_size * torch.stack(auxs).mean()

    L.moe_local = per_shard
    try:
        yield
    finally:
        L.moe_local = real


def gaps(got: dict, want: dict) -> dict:
    """Per tensor: max |got - want| over max |want|.  Also
    ``chip_smoke.py``'s."""
    return {k: float((got[k] - want[k]).abs().max()
                     / want[k].abs().max().clamp_min(1e-30))
            for k in want}


def moe_grad_case(ctx) -> dict:
    from torch.distributed.tensor.experimental import implicit_replication
    moe = L.init_weights_(L.MoE(MOE, device="cpu"), 3)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((B, T, MOE.d_model), generator=gen)
    w = torch.randn((B, T, MOE.d_model), generator=gen)
    names = [n for n, _ in moe.named_parameters()]
    x1 = x.clone().requires_grad_()
    with mesh_semantics(ctx.data_size, ctx.model_size):
        out, aux = L.moe_apply(moe, MOE, x1)
    g1 = torch.autograd.grad((out * w).sum() + AUX_W * aux,
                             [x1] + list(moe.parameters()))
    want = dict(zip(["x"] + names, g1))
    S.distribute_params(moe, _moe_specs(moe, ctx), ctx)
    spec = S.batch_shardings({"x": x}, ctx)["x"]
    xd = S.distribute(x, spec, ctx).requires_grad_()
    wd = S.distribute(w, spec, ctx)
    with mesh_context(ctx), implicit_replication():
        out, aux_m = L.moe_apply(moe, MOE, xd)
        g = torch.autograd.grad((out * wd).sum() + AUX_W * aux_m,
                                [xd] + list(moe.parameters()))
        got = {k: _whole(v) for k, v in zip(["x"] + names, g)}
    return {"grad_rel": gaps(got, want),
            "aux": float(_whole(aux_m)), "aux_want": float(aux)}


def remat_case(ctx) -> dict:
    """deepseek-v3's smoke config with ``remat`` on the mesh: the loss's
    forward under the mesh context and its backward outside it, as
    autograd runs a CUDA backward on a thread of its own where the
    thread-local context is unset; every gradient against the same
    without ``remat`` (the recomputation is the forward again)."""
    import dataclasses
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import init_params
    from repro_torch.train import lm_loss
    gen = torch.Generator().manual_seed(13)
    base = _family_cfg("deepseek-v3-671b")
    toks = torch.randint(0, base.vocab_size, (4, 17), generator=gen)
    spec = S.batch_shardings({"t": toks}, ctx)["t"]
    toks, labs = (S.distribute(t, spec, ctx)
                  for t in (toks[:, :-1], toks[:, 1:]))
    grads = {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        model = init_params(cfg, seed=0, device="cpu", trainable=True)
        S.distribute_params(model, S.params_shardings(model, ctx), ctx)
        with implicit_replication():
            with mesh_context(ctx):
                loss, aux = lm_loss(model, cfg, toks, labs)
            try:
                (loss + cfg.router_aux_coef * aux).backward()
            except Exception as e:        # every rank fails alike
                return {"error": repr(e)[:300]}
        grads[remat] = {k: _whole(p.grad) for k, p in
                        model.named_parameters()}
    return {"grad_rel": gaps(grads[True], grads[False])}


def _family_cfg(arch):
    return get_config(arch).smoke()


def _extras(cfg, C):
    """Each task's own encoder frames or patch embeddings, gathered by the
    round's matrix as its tokens are: (r, n, b, T, D), or None."""
    n_tasks = int(C.max()) + 1
    b = TRAIN_TOKENS["global_batch"] // TRAIN_ROUND["n"]
    gen = torch.Generator().manual_seed(11)
    if cfg.encoder_layers:
        key, T_ = "enc_frames", cfg.encoder_seq
    elif cfg.frontend_seq:
        key, T_ = "embeds", cfg.frontend_seq
    else:
        return None
    per_task = torch.randn((n_tasks, b, T_, cfg.frontend_dim), generator=gen)
    return {key: per_task[torch.as_tensor(C.T)]}


@contextlib.contextmanager
def first_grads(store: dict):
    """Every weight's gradient, whole, copied to the CPU, as the first
    optimizer step of the run reads it (``steps._apply_grads``).  Also
    ``chip_smoke.py``'s."""
    real = train_steps._apply_grads

    def apply(state, opt):
        if not store:
            for k, p in state.named_params().items():
                store[k] = (torch.zeros(p.shape) if p.grad is None
                            else _whole(p.grad).detach().to("cpu",
                                                            copy=True))
        return real(state, opt)

    train_steps._apply_grads = apply
    try:
        yield
    finally:
        train_steps._apply_grads = real


def train_run(arch, ctx=None, semantics=(1, 1), perturb=None) -> dict:
    """``TRAIN_STEPS`` straggler AdamW steps of ``arch``'s smoke config on
    ``ctx``'s mesh (None: one device under ``mesh_semantics(*semantics)``):
    losses, grad norms, the step-1 gradients and the last weights.  With
    ``perturb`` (a seed) each initial weight is first multiplied by 1 +
    2**-24 z, z standard normal: float32 rounding of the weights."""
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = _family_cfg(arch)
    rc = RoundConfig(**TRAIN_ROUND)
    opt = adamw(TRAIN_LR, eps=TRAIN_EPS)
    state = init_train_state(cfg, opt, seed=0, device="cpu")
    if perturb is not None:
        gen = torch.Generator().manual_seed(perturb)
        with torch.no_grad():
            for p in state.params.parameters():
                p.mul_(1 + 2.0 ** -24 * torch.randn(p.shape, generator=gen))
    step = make_straggler_train_step(cfg, opt, rc, ec2_cluster(
        rc.n, spread=3.0, persistence=0.9, seed=0))
    part = TaskPartition(n=rc.n, vocab=cfg.vocab_size, source="bigram",
                         seed=0, **TRAIN_TOKENS)
    C = rc.to_matrix()
    extras = _extras(cfg, C)
    data_sharded = 0
    if ctx is not None:
        # ZeRO-1 where the mesh has a data axis: the moments also over it
        S.distribute_train_state(state, ctx, zero1=ctx.data_size > 1)
        data_sharded = sum(not v.placements[0].is_replicate()
                           for v in state.opt_state["m"].values())
        if extras is not None:
            extras = {k: S.distribute(v, S.batch_shardings(
                {k: v}, ctx, slot_major=True)[k], ctx)
                for k, v in extras.items()}
    run = (mesh_semantics(*semantics) if ctx is None else
           _mesh_grad_ctx(ctx, implicit_replication))
    grads: dict = {}
    cluster, losses, norms = None, [], []
    with run, first_grads(grads):
        for i in range(TRAIN_STEPS):
            toks, labs = lm_task_batches(part, C, i, device="cpu")
            if ctx is not None:
                spec = S.batch_shardings({"t": toks}, ctx,
                                         slot_major=True)["t"]
                toks, labs = (S.distribute(t, spec, ctx)
                              for t in (toks, labs))
            state, m, cluster = step(state, toks, labs, 7, cluster,
                                     extras=extras)
            losses.append(float(_whole(m["loss"])))
            norms.append(float(_whole(m["grad_norm"])))
    params = {k: _whole(p).detach() for k, p in
              state.params.named_parameters()}
    return {"loss": losses, "grad_norm": norms, "grads": grads,
            "params": params, "moments_data_sharded": data_sharded}


@contextlib.contextmanager
def _mesh_grad_ctx(ctx, implicit_replication):
    with mesh_context(ctx), implicit_replication():
        yield


def _one_device_refs(rank) -> dict:
    """Ranks 2 and 3 split the one-device runs of ``TRAIN_CASES`` (the
    semantics of each case's mesh, (1, 2) or (2, 2)): each case's run,
    and its run from weights perturbed at float32 rounding."""
    out = {}
    for i, (arch, w) in enumerate(TRAIN_CASES):
        if i % 2 == rank - 2:
            out[(arch, w)] = (train_run(arch, semantics=MESHES[w]),
                              train_run(arch, semantics=MESHES[w],
                                        perturb=PERTURB_SEED))
    return out


def _compare(got, refs) -> dict:
    want, perturbed = refs
    diffs = torch.cat([(got["params"][k] - want["params"][k]).abs()
                       .flatten() for k in want["params"]])
    return {"loss": got["loss"], "loss_want": want["loss"],
            "grad_norm": got["grad_norm"], "grad_norm_want":
            want["grad_norm"], "grad_rel": gaps(got["grads"],
                                                 want["grads"]),
            "grad_rounding": gaps(perturbed["grads"], want["grads"]),
            "param_max": max(float(p.abs().max())
                             for p in want["params"].values()),
            "param_diff_max": float(diffs.max()),
            "n_params": diffs.numel(),
            "moments_data_sharded": got["moments_data_sharded"]}


def _rank(rank, world, port, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        ctxs = {w: make_local_mesh_ctx(*MESHES[w], device_type="cpu")
                for w in MESHES}
        res: dict = {"moe": {}, "train": {}}
        mine: dict = {}
        refs = None
        for w, ctx in ctxs.items():
            if rank < w:
                res["moe"][w] = moe_grad_case(ctx)
        if rank < 2:
            res["remat"] = remat_case(ctxs[2])
        if rank < 2:
            for arch, w in TRAIN_CASES:
                if w == 2:
                    mine[(arch, w)] = train_run(arch, ctxs[2])
        else:
            refs = _one_device_refs(rank)
        for arch, w in TRAIN_CASES:
            if w == 4:
                mine[(arch, w)] = train_run(arch, ctxs[4])
        gathered = [None] * world
        dist.all_gather_object(gathered, refs)
        if rank == 0:
            want = {**gathered[2], **gathered[3]}
            res["train"] = {f"{a}@{w}": _compare(got, want[(a, w)])
                            for (a, w), got in mine.items()}
        else:
            res["train"] = {f"{a}@{w}": {"loss": got["loss"],
                                         "grad_norm": got["grad_norm"]}
                            for (a, w), got in mine.items()}
        dist.all_gather_object(gathered, res)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(gathered, f)
    finally:
        dist.destroy_process_group()


def moe_dry() -> dict:
    """The expert-parallel MoE layer (``MOE`` without the shared expert)
    on a 1 x 2 ``meta`` mesh: forward, ``autograd.grad`` of out.sum() +
    aux for the input and every weight, then each gradient brought to its
    tensor's placements (its pending sums reduced, as an optimizer reads
    it), each under its own ``dryrun.MeshTrafficMode``."""
    import dataclasses
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import dryrun
    ctx = dryrun.make_ctx("1x2")
    cfg = dataclasses.replace(MOE, n_shared_experts=0)
    moe = L.MoE(cfg, device="meta")
    S.distribute_params(moe, _moe_specs(moe, ctx), ctx)
    x = torch.empty((B, T, cfg.d_model), device="meta")
    xd = S.distribute(x, S.batch_shardings({"x": x}, ctx)["x"], ctx)
    xd.requires_grad_()
    ins = [xd] + list(moe.parameters())
    modes = {k: dryrun.MeshTrafficMode() for k in ("forward", "backward",
                                                   "read")}
    with mesh_context(ctx), implicit_replication():
        with modes["forward"]:
            out, aux = L.moe_apply(moe, cfg, xd)
            obj = out.sum() + aux
        with modes["backward"]:
            grads = torch.autograd.grad(obj, ins)
        with modes["read"]:
            for g, t in zip(grads, ins):
                g.redistribute(t.device_mesh, t.placements)
    return {"tokens": B * T, "d": cfg.d_model, "experts": cfg.n_experts,
            **{k: {"bytes": m.coll, "counts": m.coll_counts}
               for k, m in modes.items()}}


def main_dry(out: str) -> None:
    import torch.distributed as dist
    try:
        res = moe_dry()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)


def main(out: str) -> None:
    world = max(MESHES)
    mp.spawn(_rank, args=(world, _free_port(), out), nprocs=world,
             join=True)


if __name__ == "__main__":
    if sys.argv[1] == "--dry":
        main_dry(sys.argv[2])
    else:
        main(sys.argv[1])
