"""How far bf16 rounding alone moves jamba's straggler train steps, beside
how far the 1 x 2 mesh moves them, on one CUDA card.

The case is ``chip_smoke.py``'s ``jamba_bf16_cut`` (jamba-v0.1-52b's
published widths cut to a Mamba + SwiGLU and an attention + MoE layer, 16
experts of d_ff 14 336, bf16, three steps of its straggler round).  At
each AdamW eps of ``EPS``: one device from the seeded weights, one device
from those weights each times ``1 + 2**-8 z`` (z standard normal, one run
a seed of ``SEEDS``; the first two seeds at every eps but the first), and
the 1 x 2 mesh over two gloo ranks on ``cuda:0`` (8 experts a rank), as
the smoke's mesh train leg runs them.  At the first eps the unperturbed
one-device run, the first seed's run and the mesh also record, per
weight, a strided sample of at most ``SAMPLE`` elements of the gradient
at steps 1 and 2 and of the weights after step 1 (``_sample``): each is held to the
unperturbed run's by max |a - b| over max |b| on the sample, and the
weights after step 1 by the share of sampled elements more than lr
apart (an AdamW step of lr at eps 1e-8 whose gradient sign differs).

Run on a machine with a card, from the repository root:

    python3 -m benchmarks_torch.mesh_train_spread

Prints the card's name and power limit first, then one line a run and
one JSON object of the comparisons last.
"""
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as C  # noqa: E402
from repro_torch.sharding import (all_reduce, is_dtensor,  # noqa: E402
                                  reduce_partial)
from repro_torch.train import steps as train_steps  # noqa: E402

#: the most elements of one weight's sample
SAMPLE = 1 << 20
CASE = "jamba_bf16_cut"
SEEDS = (1, 2, 3, 4, 5)
EPS = (1e-8, 1e-5)


def _sample(t):
    """Elements 0, s, 2s, ... of ``t`` flattened whole (s = numel //
    ``SAMPLE``, at least 1), float32, on the CPU.  A DTensor's pending
    sums are reduced first (``reduce_partial``); each rank takes the
    sampled elements its block holds, and the blocks' zeros elsewhere are
    summed over each sharded mesh dim (float32 sums, ``all_reduce``), so
    nothing gathers a weight whole."""
    stride = max(1, t.numel() // SAMPLE)
    if not is_dtensor(t):
        return t.detach().flatten()[::stride].float().cpu()
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    t = reduce_partial(t)
    shape = tuple(t.shape)
    idx = torch.arange(0, t.numel(), stride, device=t.device)
    coords = list(torch.unravel_index(idx, shape))
    lshape, off = compute_local_shape_and_global_offset(
        shape, t.device_mesh, t.placements)
    own = torch.ones_like(idx, dtype=torch.bool)
    for d, size in enumerate(lshape):
        c = coords[d] - off[d]
        own &= (c >= 0) & (c < size)
        coords[d] = c.clamp(0, max(size - 1, 0))
    vals = torch.where(own, t.to_local().detach()[tuple(coords)].float(),
                       0.0)
    for i, p in enumerate(t.placements):
        if p.is_shard():
            vals = all_reduce(vals, "sum", t.device_mesh.get_group(i))
    return vals.cpu()


@contextlib.contextmanager
def sampled(store):
    """``store["grad1"]``, ``["grad2"]``: each weight's gradient sample as
    the first and second optimizer steps read it; ``["w1"]``: the weights'
    after the first step."""
    real = train_steps._apply_grads

    def apply(state, opt):
        call = sum(k.startswith("grad") for k in store) + 1
        if call <= 2:
            params = state.named_params()
            store[f"grad{call}"] = {
                k: _sample(p.grad) for k, p in params.items()
                if p.grad is not None}
            if call == 2:
                store["w1"] = {k: _sample(p) for k, p in params.items()}
        return real(state, opt)

    train_steps._apply_grads = apply
    try:
        yield
    finally:
        train_steps._apply_grads = real


def _gaps(got, want, lr):
    """Per sample set: the largest max |a - b| / max |b| over the weights
    (and which), and for the weights the largest share more than lr
    apart."""
    out = {}
    for key in want:
        rel = {k: float((got[key][k] - w).abs().max()
                        / w.abs().max().clamp_min(1e-30))
               for k, w in want[key].items()}
        top = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
        out[key] = {"max_rel": top[0][1], "top": top}
        if key == "w1":
            out[key]["share_past_lr"] = max(
                float(((got[key][k] - w).abs() > lr).float().mean())
                for k, w in want[key].items())
    return out


def _run(cfg, eps, ctx=None, perturb=None, store=None):
    t0 = time.perf_counter()
    with (sampled(store) if store is not None
          else contextlib.nullcontext()):
        r, _ = C._mesh_train(cfg, eps, ctx, perturb=perturb)
    r["wall_s"] = time.perf_counter() - t0
    return r


def rank_fn(rank, world, port):
    ctx = C._rank_group(rank, world, port)
    cfg = C.mesh_train_cases()[CASE][0]
    res = {"rank": rank}
    for j, eps in enumerate(EPS):
        store = {} if j == 0 else None
        res[str(eps)] = _run(cfg, eps, ctx, store=store)
        if store is not None and rank == 0:
            torch.save(store, C.MESH_DIR / "spread_mesh.pt")
    C._rank_report(rank, res, "spread_ranks.json")


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card {card}; torch {torch.__version__}", flush=True)
    C.MESH_DIR.mkdir(parents=True, exist_ok=True)
    cfg = C.mesh_train_cases()[CASE][0]
    lr = C.MESH_TRAIN_LR
    one, samples = {}, {}
    for j, eps in enumerate(EPS):
        for seed in (None,) + (SEEDS if j == 0 else SEEDS[:2]):
            store = {} if j == 0 and seed in (None, SEEDS[0]) else None
            r = _run(cfg, eps, perturb=seed, store=store)
            one[f"{eps:g}/{seed}"] = r
            if store is not None:
                samples[seed] = store
            print(f"one device eps {eps:g} seed {seed}: loss {r['loss']}, "
                  f"grad norm {r['grad_norm']}, s a step {r['step_s']}, "
                  f"wall {r['wall_s']:.2f} s", flush=True)
    C._spawn_ranks(rank_fn)
    ranks = json.loads((C.MESH_DIR / "spread_ranks.json").read_text())
    for r in ranks:
        for eps in EPS:
            g = r[str(eps)]
            print(f"rank {r['rank']} eps {eps:g}: loss {g['loss']}, grad "
                  f"norm {g['grad_norm']}, s a step {g['step_s']}",
                  flush=True)
    mesh = torch.load(C.MESH_DIR / "spread_mesh.pt")
    base = samples[None]
    out = {"card": card, "case": CASE, "lr": lr, "sample": SAMPLE,
           "grad_norm_rel": {}, "loss_rel": {},
           "mesh_vs_one": _gaps(mesh, base, lr),
           f"seed{SEEDS[0]}_vs_one": _gaps(samples[SEEDS[0]], base, lr)}
    for eps in EPS:
        want = one[f"{eps:g}/None"]
        for name, got in [(k, v) for k, v in one.items()
                          if k.startswith(f"{eps:g}/")
                          and not k.endswith("/None")] + [
                (f"{eps:g}/rank{r['rank']}", r[str(eps)]) for r in ranks]:
            for key in ("grad_norm", "loss"):
                out[f"{key}_rel"][name] = [abs(a - b) / abs(b) for a, b in
                                           zip(got[key], want[key])]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
