"""Multi-rank checks of the port's mesh code over gloo on the CPU, for
``tests/test_torch_mesh_collectives.py``: ``main(out)`` spawns 4 ranks on
one thread each over gloo, runs the checks on a 2 x 2 mesh of all four
and on a 1 x 2 mesh of ranks 0 and 1 (the group of 2), and writes what
every rank of each saw as JSON:

* the expert-parallel ``moe_apply`` (8 experts, top 2, capacity 1, a
  shared expert; weights and tokens sharded by the port's rules) against
  the one-device ``moe_apply`` on each data shard's tokens: the largest
  output difference over the largest output, and the aux against
  model_size x the mean of the shards' one-device aux (the reference's
  sum over every axis over the data size);
* three ring-decode steps (``seq_shard_decode``, cache sharded by the
  port's rule: heads when the model axis divides K, else the sequence)
  against the one-device grouped decode: the largest output difference,
  the caches gathered against the one-device caches, and on each rank not
  owning the written position its local block before against after;
* three straggler AdamW train steps (``make_straggler_train_step``,
  phi4-mini-3.8b's smoke config in float32, ``TRAIN_ROUND``) with the
  state placed by ``shardings.distribute_train_state`` and the slot-major
  batches by ``batch_shardings``, against the same steps on one device:
  each step's loss and grad norm, and the weights after the last step
  (``TRAIN_CASES``: AdamW as the trainer runs it, AdamW at eps 1e-5, the
  optimizer state ZeRO-1 sharded, and ``reduce_partial``'s half-precision
  gloo branch ``_ReduceHalf`` taken by float32 CPU tensors);
* ``_ReduceHalf`` alone on a float32 pending sum: the forward against
  DTensor's ``redistribute``, the input's gradient under a pending-sum
  output gradient against the all-reduce of that gradient, and under a
  replicated one against the gradient itself;
* ``launch/mesh.py``'s c10d all-gather (the route a CUDA mesh over gloo
  takes) forced for CPU tensors, against the functional all-gather on
  dims 0, 1 and 2;
* the sampled decode's draw under the mesh: logits sharded by vocabulary
  over the model axis, gathered as ``make_serve_step`` gathers them, then
  ``gumbel_scores``, against the same on the whole logits.
"""
from __future__ import annotations

import contextlib
import json
import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import sharding
from repro_torch.configs import get_config
from repro_torch.core import RoundConfig, ec2_cluster
from repro_torch.data import TaskPartition, lm_task_batches
from repro_torch.launch import shardings as S
from repro_torch.launch.mesh import make_local_mesh_ctx
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.sharding import mesh_context
from repro_torch.train import init_train_state, make_straggler_train_step

MESHES = {2: (1, 2), 4: (2, 2)}
MOE = ModelConfig(name="moe", arch_type="moe", n_layers=1, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=97,
                  n_experts=8, experts_per_token=2, d_ff_expert=32,
                  n_shared_experts=1, capacity_factor=1.0,
                  param_dtype="float32", dtype="float32", remat=False)
ATT = ModelConfig(name="att", arch_type="dense", n_layers=1, d_model=64,
                  n_heads=8, n_kv_heads=2, head_dim=16, d_ff=128,
                  vocab_size=97, param_dtype="float32", dtype="float32",
                  remat=False)
B, T, S_CACHE, PREFILL, STEPS = 4, 6, 16, 5, 3


def _moe_specs(moe, ctx):
    return {n: S.param_spec("segments/0/0/ffn/" + n.replace(".", "/"),
                            tuple(p.shape), ctx)
            for n, p in moe.named_parameters()}


def moe_case(ctx) -> dict:
    from torch.distributed.tensor.experimental import implicit_replication
    moe = L.init_weights_(L.MoE(MOE, device="cpu"), 3).requires_grad_(False)
    x = torch.randn((B, T, MOE.d_model),
                    generator=torch.Generator().manual_seed(5))
    ds = ctx.data_size
    outs, auxs = [], []
    for xs in x.chunk(ds):
        o, a = L.moe_apply(moe, MOE, xs)
        outs.append(o)
        auxs.append(a)
    want, want_aux = torch.cat(outs), ctx.model_size * torch.stack(
        auxs).mean()
    S.distribute_params(moe, _moe_specs(moe, ctx), ctx)
    xd = S.distribute(x, S.batch_shardings({"x": x}, ctx)["x"], ctx)
    with mesh_context(ctx), implicit_replication(), torch.no_grad():
        out, aux = L.moe_apply(moe, MOE, xd)
    got = out.full_tensor()
    return {"out_err": float((got - want).abs().max() / want.abs().max()),
            "aux": float(aux.full_tensor()), "aux_want": float(want_aux),
            "weights_local": list(moe.w_gate.to_local().shape)}


def ring_case(ctx) -> dict:
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = ATT.__class__(**{**ATT.__dict__, "seq_shard_decode": True})
    plain_cfg = ATT.__class__(**{**ATT.__dict__, "grouped_gqa": True})
    attn = L.init_weights_(L.Attention(cfg, device="cpu"), 7)
    attn.requires_grad_(False)
    plain = L.Attention(plain_cfg, device="cpu").requires_grad_(False)
    plain.load_state_dict(attn.state_dict())
    x = torch.randn((B, PREFILL + STEPS, cfg.d_model),
                    generator=torch.Generator().manual_seed(9))
    cache = L.gqa_cache_init(plain_cfg, B, S_CACHE, device="cpu")
    pos = torch.arange(PREFILL)[None]
    L.gqa_apply(plain, plain_cfg, x[:, :PREFILL], positions=pos, cache=cache)
    cache["pos"] = PREFILL
    specs = {n: S.param_spec("segments/0/0/mixer/" + n.replace(".", "/"),
                             tuple(p.shape), ctx)
             for n, p in attn.named_parameters()}
    S.distribute_params(attn, specs, ctx)
    dcache = {k: S.distribute(cache[k].clone(),
                              tuple(S.cache_leaf_spec(k, cache[k].shape,
                                                      ctx)[0]), ctx)
              for k in ("k", "v")}
    dcache["pos"] = PREFILL
    rank_m = ctx.mesh.get_local_rank(ctx.model_axis)
    out_err, untouched, owners = 0.0, [], []
    for t in range(PREFILL, PREFILL + STEPS):
        p_t = torch.tensor([[t]])
        want, cache = L.gqa_apply(plain, plain_cfg, x[:, t:t + 1],
                                  positions=p_t, cache=cache)
        xd = S.distribute(x[:, t:t + 1], S.batch_shardings(
            {"x": x}, ctx)["x"], ctx)
        before = dcache["k"].to_local().clone()
        seq_sharded = any(getattr(p, "dim", None) == 2
                          for p in dcache["k"].placements)
        with mesh_context(ctx), implicit_replication(), torch.no_grad():
            got, dcache = L.gqa_apply(attn, cfg, xd, positions=p_t,
                                      cache=dcache)
        out_err = max(out_err, float((got.full_tensor() - want).abs().max()))
        if seq_sharded:
            sl = S_CACHE // ctx.model_size
            owns = rank_m * sl <= t < (rank_m + 1) * sl
            owners.append(owns)
            if not owns:
                untouched.append(bool(torch.equal(
                    before, dcache["k"].to_local())))
    equal = all(torch.equal(dcache[k].full_tensor(), cache[k])
                for k in ("k", "v"))
    return {"out_err": out_err, "cache_equal": equal,
            "pos": dcache["pos"], "untouched": untouched,
            "owned_steps": sum(owners),
            "seq_sharded_after": [str(p) for p in dcache["k"].placements]}


TRAIN_ARCH = "phi4-mini-3.8b"
TRAIN_STEPS = 3
#: the round of the train case: 4 workers (2 a data rank on 2 x 2), r = 2
TRAIN_ROUND = dict(n=4, k=3, kind="ss", r=2)
#: (mesh world, AdamW eps, zero1, reduce_partial through _ReduceHalf)
TRAIN_CASES = {"adamw": (2, 1e-8, False, False),
               "adamw_eps": (2, 1e-5, False, False),
               "half_branch": (2, 1e-8, False, True),
               "adamw_2x2": (4, 1e-8, False, False),
               "zero1_2x2": (4, 1e-8, True, False)}


def _train(ctx, eps, zero1=False):
    """``TRAIN_STEPS`` straggler AdamW steps on ``ctx``'s mesh (None: one
    device): (losses, grad norms, the weights after the last step, the
    number of first moments sharded over the data axis)."""
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = get_config(TRAIN_ARCH).smoke()
    rc = RoundConfig(**TRAIN_ROUND)
    opt = adamw(1e-3, eps=eps)
    state = init_train_state(cfg, opt, seed=0, device="cpu")
    step = make_straggler_train_step(cfg, opt, rc, ec2_cluster(
        rc.n, spread=3.0, persistence=0.9, seed=0))
    part = TaskPartition(n=rc.n, global_batch=8, seq_len=16,
                         vocab=cfg.vocab_size, source="bigram", seed=0)
    data_sharded = 0
    if ctx is not None:
        S.distribute_train_state(state, ctx, zero1=zero1)
        data_sharded = sum(not v.placements[0].is_replicate()
                           for v in state.opt_state["m"].values())
    run = (contextlib.nullcontext if ctx is None else
           lambda: _mesh_grad_ctx(ctx, implicit_replication))
    cluster, losses, norms = None, [], []
    for i in range(TRAIN_STEPS):
        toks, labs = lm_task_batches(part, rc.to_matrix(), i, device="cpu")
        if ctx is not None:
            spec = S.batch_shardings({"t": toks}, ctx, slot_major=True)["t"]
            toks, labs = (S.distribute(t, spec, ctx) for t in (toks, labs))
        with run():
            state, m, cluster = step(state, toks, labs, 7, cluster)
        losses.append(float(_whole(m["loss"])))
        norms.append(float(_whole(m["grad_norm"])))
    params = {k: _whole(p).detach() for k, p in
              state.params.named_parameters()}
    return losses, norms, params, data_sharded


def _whole(t):
    return t.full_tensor() if sharding.is_dtensor(t) else t


@contextlib.contextmanager
def _mesh_grad_ctx(ctx, implicit_replication):
    with mesh_context(ctx), implicit_replication():
        yield


@contextlib.contextmanager
def _half_branch(on):
    """``reduce_partial`` through ``_ReduceHalf`` for every tensor while
    ``on`` (its float32 casts are no-ops on float32)."""
    real = sharding._half_on_gloo
    if on:
        sharding._half_on_gloo = lambda t, group: True
    try:
        yield
    finally:
        sharding._half_on_gloo = real


def train_case(ctx, name, one_device) -> dict:
    _, eps, zero1, half = TRAIN_CASES[name]
    if eps not in one_device:
        one_device[eps] = _train(None, eps)
    want_l, want_n, want_p, _ = one_device[eps]
    with _half_branch(half):
        got_l, got_n, got_p, data_sharded = _train(ctx, eps, zero1)
    diffs = torch.cat([(got_p[k] - want_p[k]).abs().flatten()
                       for k in want_p])
    return {"loss": got_l, "loss_want": want_l, "grad_norm": got_n,
            "grad_norm_want": want_n, "param_max": max(
                float(p.abs().max()) for p in want_p.values()),
            "param_diffs": torch.sort(diffs, descending=True).values[
                :64].tolist(), "n_params": diffs.numel(),
            "moments_data_sharded": data_sharded}


def reduce_half_case(ctx) -> dict:
    """``_ReduceHalf`` on a float32 pending sum over the model axis."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = ctx.mesh
    group = mesh.get_group(ctx.model_axis)
    pend = [Replicate(), Partial()]
    gen = torch.Generator().manual_seed(dist.get_rank() + 1)
    xl = torch.randn((3, 5), generator=gen)
    gl = torch.randn((3, 5), generator=gen)
    everyone = [torch.empty_like(gl) for _ in range(mesh.size())]
    dist.all_gather(everyone, gl, group=group)
    out = {}
    for name, g_pl in (("pending", pend), ("replicated", [Replicate()] * 2)):
        x = DTensor.from_local(xl.clone().requires_grad_(), mesh, pend)
        y = sharding._ReduceHalf.apply(x)
        g = DTensor.from_local(gl, mesh, g_pl)
        (gx,) = torch.autograd.grad(y, x, g)
        want_g = torch.stack(everyone).sum(0) if name == "pending" else gl
        out[name] = {
            "forward_equal": bool(torch.equal(
                y.to_local(), x.redistribute(mesh, [Replicate()] * 2)
                .to_local())),
            "placements": [str(p) for p in y.placements],
            "grad_err": float((_whole(gx) - want_g).abs().max())}
    return out


def c10d_gather_case(ctx) -> dict:
    """The c10d all-gather route, taken by CPU tensors, against the
    functional all-gather it stands in for."""
    import torch.distributed._functional_collectives as funcol
    from repro_torch.launch import mesh as M
    shim = M._c10d_all_gather(funcol.all_gather_tensor,
                              route=lambda t, pg: True)
    gen = torch.Generator().manual_seed(dist.get_rank() + 11)
    x = torch.randn((3, 4, 5), generator=gen)
    group = (ctx.mesh, 1)
    out = {}
    for dim in range(3):
        want = funcol.wait_tensor(funcol.all_gather_tensor(x, dim, group))
        out[dim] = bool(torch.equal(shim(x, dim, group), want))
    return out


def sample_case(ctx) -> dict:
    """``gumbel_scores`` of vocabulary-sharded logits, gathered first."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.sharding import gather
    from repro_torch.train import gumbel_scores
    logits = torch.randn((4, 96), generator=torch.Generator().manual_seed(2))
    want = gumbel_scores(logits, (3, 1))
    dl = S.distribute(logits, (None, ctx.model_axis), ctx)
    with mesh_context(ctx), implicit_replication():
        got = gumbel_scores(gather(dl, -1), (3, 1))
    return {"sharded": [str(p) for p in dl.placements],
            "placements": [str(p) for p in got.placements],
            "equal": bool(torch.equal(got.full_tensor(), want)),
            "tokens_equal": bool(torch.equal(got.full_tensor().argmax(-1),
                                             want.argmax(-1)))}


def _rank(rank, world, port, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        # every rank builds every mesh (its groups are made by all)
        ctxs = {w: make_local_mesh_ctx(*MESHES[w], device_type="cpu")
                for w in MESHES}
        res = {w: {"moe": moe_case(ctx), "ring": ring_case(ctx)}
               for w, ctx in ctxs.items() if rank < w}
        if rank < 2:
            res[2]["reduce_half"] = reduce_half_case(ctxs[2])
            res[2]["c10d_gather"] = c10d_gather_case(ctxs[2])
            res[2]["sample"] = sample_case(ctxs[2])
        one_device: dict = {}
        for name, (w, *_rest) in TRAIN_CASES.items():
            if rank < w:
                res[w].setdefault("train", {})[name] = train_case(
                    ctxs[w], name, one_device)
        gathered = [None] * world
        dist.all_gather_object(gathered, res)
        if rank == 0:
            with open(out, "w") as f:
                json.dump({w: [g[w] for g in gathered if w in g]
                           for w in MESHES}, f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(out: str) -> None:
    world = max(MESHES)
    mp.spawn(_rank, args=(world, _free_port(), out), nprocs=world,
             join=True)


if __name__ == "__main__":
    main(sys.argv[1])
