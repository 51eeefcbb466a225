"""Train a ~100M-parameter LM for a few hundred straggler-scheduled SGD
rounds on the PyTorch port, comparing the loss-vs-wall-clock curves of CS /
SS / RA and the feedback-driven adaptive schedule (counterpart of
``examples/train_lm_straggler.py``).  The eq.-(61) estimator is
schedule-independent in expectation, so schedules separate on the
wall-clock axis, not on the loss-per-step axis.

Every schedule sees the SAME virtual cluster realization (common random
numbers): one delay seed keys every schedule's rounds, and a round-aware
``DelayProcess`` keeps each worker's straggler state across rounds
(``--cluster markov|ar1``; ``--cluster iid`` is the stateless model).

~100M params: 12L, d_model=768, 12H (kv=4), d_ff=3072, vocab=32768.  Data:
the synthetic bigram chain (learnable).  ``--smoke`` trains a 2-layer
model of width 64 instead.

Run:  PYTHONPATH=src python examples_torch/train_lm_straggler.py \\
          [--steps 300] [--schedules ss,cs,ra,adaptive] [--n 8 --r 2 --k 6] \\
          [--cluster markov --persistence 0.95 --spread 3] [--device cpu]

Emits ``curve,<sched>,<step>,<wallclock_ms>,<loss>`` rows (the
loss-vs-wall-clock curve per schedule) plus a final summary table.
"""
import argparse
import time

import numpy as np

from repro_torch.ckpt import save_checkpoint
from repro_torch.core import (AR1Process, AdaptiveScheduler,
                              BimodalStragglerDelays, RoundConfig,
                              ec2_cluster, heterogeneous_scales, scenario1)
from repro_torch.data import TaskPartition, lm_task_batches
from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig, num_params
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.train import init_train_state, make_straggler_train_step

DELAY_SEED = 1000          # one delay stream for every schedule


def lm_100m() -> ModelConfig:
    return ModelConfig(
        name="lm-100m", arch_type="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=3072, vocab_size=32768,
        param_dtype="float32", dtype="float32", remat=False,
        max_seq_len=2048)


def lm_smoke() -> ModelConfig:
    return ModelConfig(
        name="lm-smoke", arch_type="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
        param_dtype="float32", dtype="float32", remat=False,
        max_seq_len=512)


def build_cluster(args):
    """``--straggle`` layers i.i.d. bimodal slowdowns on the base delays in
    every cluster mode (as ``repro_torch.launch.train`` does)."""
    base = (BimodalStragglerDelays(p_straggle=0.3, slow=8.0)
            if args.straggle else scenario1())
    if args.cluster == "iid":
        return base
    if args.cluster == "markov":
        return ec2_cluster(args.n, spread=args.spread, p_slow=0.25,
                           persistence=args.persistence, slow=8.0,
                           base=base, seed=1)
    return AR1Process(base=base,
                      worker_scale=heterogeneous_scales(args.n, args.spread,
                                                        seed=1),
                      rho=args.persistence, sigma=0.4)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--schedules", default="ss,cs,ra")
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--r", type=int, default=2)
    ap.add_argument("--k", type=int, default=6)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--straggle", action="store_true",
                    help="layer i.i.d. bimodal slowdowns on the base "
                         "delays (all cluster modes)")
    ap.add_argument("--cluster", default="iid",
                    choices=("iid", "markov", "ar1"))
    ap.add_argument("--persistence", type=float, default=0.95)
    ap.add_argument("--spread", type=float, default=3.0)
    ap.add_argument("--curve-every", type=int, default=0,
                    help="emit a curve row every N steps (0: steps//20)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="a 2-layer model of width 64 (CPU-runnable)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = lm_smoke() if args.smoke else lm_100m()
    delay = build_cluster(args)
    part = TaskPartition(n=args.n, global_batch=args.batch,
                         seq_len=args.seq, vocab=cfg.vocab_size,
                         source="bigram")
    every = args.curve_every or max(args.steps // 20, 1)
    results = {}
    schedules = args.schedules.split(",")
    for sched in schedules:
        adaptive = sched == "adaptive"
        base = "cs" if adaptive else sched
        r = args.n if base == "ra" else args.r
        rc = RoundConfig(n=args.n, k=args.k, kind=base, r=r)
        opt = adamw(cosine_schedule(3e-4, args.steps, warmup=20),
                    weight_decay=0.01)
        state = init_train_state(cfg, opt, seed=0, device=dev)
        if sched == schedules[0]:
            print(f"model params: {num_params(state.params):,} on {dev}")
        step = make_straggler_train_step(cfg, opt, rc, delay)
        base_C = rc.to_matrix()
        scheduler = (AdaptiveScheduler(base_C, device=dev) if adaptive
                     else None)
        cluster = None
        losses, vclock, curve = [], 0.0, []
        t0 = time.time()
        for i in range(args.steps):
            C = base_C if scheduler is None else scheduler.matrix()
            row = None if scheduler is None else scheduler.row_of_worker()
            toks, labs = lm_task_batches(part, C, i, device=dev)
            state, m, cluster = step(state, toks, labs, DELAY_SEED,
                                     cluster, row)
            if scheduler is not None:
                scheduler.observe(m["worker_t1"].cpu().numpy())
            losses.append(float(m["loss"]))
            vclock += float(m["completion_time"])
            if i % every == 0 or i == args.steps - 1:
                curve.append((i, vclock, losses[-1]))
            if i % max(args.steps // 10, 1) == 0:
                print(f"  [{sched}] step {i:4d} loss {losses[-1]:.4f} "
                      f"vclock {vclock * 1e3:.2f} ms")
        results[sched] = (np.mean(losses[-20:]), vclock, time.time() - t0)
        for i, vc, l in curve:
            print(f"curve,{sched},{i},{vc * 1e3:.4f},{l:.4f}")
        if args.ckpt:
            save_checkpoint(f"{args.ckpt}-{sched}", state.tree(),
                            step=args.steps)

    print(f"\n{'sched':9s} {'final loss':>11s} {'virtual time':>13s} "
          f"{'wall time':>10s}")
    for sched, (l, vc, wt) in results.items():
        print(f"{sched:9s} {l:11.4f} {vc * 1e3:10.2f} ms {wt:9.1f} s")
    if "ss" in results and "ra" in results:
        gain = 100 * (results["ra"][1] - results["ss"][1]) / results["ra"][1]
        print(f"\nSS vs RA virtual-completion-time reduction: {gain:.1f}% "
              f"(paper Fig. 5: ~28.5% at r=n; here r={args.r})")
    if "adaptive" in results and "cs" in results:
        gain = 100 * (results["cs"][1] - results["adaptive"][1]) \
            / results["cs"][1]
        print(f"adaptive vs CS wall-clock reduction: {gain:.1f}%")
    return results


if __name__ == "__main__":
    main()
