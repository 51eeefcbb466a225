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
  owning the written position its local block before against after.
"""
from __future__ import annotations

import json
import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.launch import shardings as S
from repro_torch.launch.mesh import make_local_mesh_ctx
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import mesh_context

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
