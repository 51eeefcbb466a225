"""Training launcher of the port (counterpart of ``repro.launch.train``).

Straggler-scheduled training of any of the port's ``--arch`` (full or
``--smoke`` reduced config, for a hybrid the reference CLI's cut that
keeps an attention layer) with the paper's CS/SS/RA schedules,
round-aware cluster processes and optional adaptive row re-assignment
(``AdaptiveScheduler``: one greedy_assign launch a step on the card).
Runs on the CUDA card unless given ``--device cpu``; one card holds the
weights, their gradients and the AdamW moments, and a model whose state
does not fit is refused before anything is allocated.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-4b \\
      --steps 20 --n 8 --r 2 --k 6 --batch 16 --seq 64 --schedule ss \\
      --cluster markov --persistence 0.95 --spread 3 --adaptive
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-4b \\
      --smoke --steps 4 --device cpu

Record / replay: ``--log-delays PATH`` writes every round's realized
per-(worker, slot) delays to a versioned trace file (``core.trace``);
``--cluster trace --trace PATH`` drives a later run from such a recording
(or from the JAX package's, or the engine's) instead of a parametric
model.  The delays of a run seeded ``--seed`` are the rounds engine's
trial-0 tables of the same process (``train.steps``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import List, Optional

import numpy as np
import torch

from ..ckpt import latest_checkpoint, load_checkpoint, save_checkpoint
from ..configs import ARCH_IDS, cli_config
from ..core import (FAULT_SCENARIOS, AdaptiveScheduler, DelayTrace,
                    RoundConfig, TraceProcess, as_process, save_trace)
from ..data import TaskPartition, lm_task_batches
from ..device import resolve_device
from ..kernels import ops
from ..models import init_params, num_params
from ..models.config import ModelConfig
from ..optim import adamw, cosine_schedule
from ..train import TrainState, init_train_state, make_straggler_train_step
from .cluster import build_cluster, derive_seeds

__all__ = ["TrainResult", "state_bytes", "main"]

#: what training keeps a weight in besides itself: its gradient (the
#: weight's dtype) and AdamW's two float32 moments
_MOMENT_BYTES = 8


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    history: List[dict]        # per step: host numbers of its metrics
    step_seconds: List[float]  # wall seconds of each step (synchronised)
    start: int                 # the step the run began at (resume)
    trace_path: Optional[str]  # the --log-delays file
    ckpt_path: Optional[str]   # the checkpoint written at the end
    seeds: dict                # derive_seeds(--seed) plus the port's ints


def state_bytes(cfg: ModelConfig) -> int:
    """Bytes of the training state of ``cfg``: weights, gradients and the
    AdamW moments (counted on the ``meta`` device, nothing allocated)."""
    return sum(p.numel() * (2 * p.element_size() + _MOMENT_BYTES)
               for p in init_params(cfg, device="meta").parameters())


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Straggler-scheduled training with record/replay "
                    "delay sources, on the CUDA card.",
        epilog="Determinism: a single --seed derives every randomness "
               "stream (parameter init, data pipeline, per-round delay "
               "realizations, RA schedule construction), so one integer "
               "pins the whole run; --log-delays / --cluster trace make "
               "the delay stream itself recordable and replayable.")
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--config", default=None, metavar="PATH",
                    help="load the round configuration from a serialized "
                         "RoundConfig JSON document (RoundConfig.save / "
                         "to_json); overrides --n/--r/--k/--schedule/"
                         "--loads/--adaptive/--deadline/--deadline-policy/"
                         "--dead-after")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--r", type=int, default=2)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--schedule", default="ss",
                    choices=("cs", "ss", "ra", "block"))
    ap.add_argument("--adaptive", action="store_true",
                    help="re-assign schedule rows each round from feedback")
    ap.add_argument("--loads", default=None,
                    help="comma-separated per-worker loads (ragged rounds), "
                         "e.g. 3,1,2,3 — each <= r; r is then the grid "
                         "width / load cap")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0,
                    help="root seed; derives the data, delay, schedule and "
                         "init streams, so one integer reproduces the run")
    ap.add_argument("--straggle", action="store_true",
                    help="layer i.i.d. bimodal slowdowns on the base "
                         "delays (parametric cluster modes)")
    ap.add_argument("--cluster", default="iid",
                    choices=("iid", "markov", "ar1", "trace"),
                    help="round-aware delay process for the virtual "
                         "cluster; 'trace' replays a recorded delay trace "
                         "(--trace PATH)")
    ap.add_argument("--trace", default=None,
                    help="delay-trace file (.npz from --log-delays or "
                         "save_trace) for --cluster trace")
    ap.add_argument("--trace-pad", default="error",
                    choices=("error", "cycle", "hold"),
                    help="what to do when --steps exceeds the recorded "
                         "rounds: fail, wrap around, or hold the final "
                         "round")
    ap.add_argument("--log-delays", default=None, metavar="PATH",
                    help="record every round's realized per-(worker, "
                         "slot) compute/comm delays and write them to PATH "
                         "as a versioned delay trace (replayable via "
                         "--cluster trace)")
    ap.add_argument("--scenario", default="none",
                    choices=("none",) + FAULT_SCENARIOS,
                    help="overlay a named fault scenario on the parametric "
                         "cluster modes")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-round wall-clock cap (seconds, virtual)")
    ap.add_argument("--deadline-policy", default="wait",
                    choices=("wait", "close_partial", "reissue"),
                    help="fallback at the deadline: report+flag the miss, "
                         "close with whatever arrived, or close partial "
                         "and re-gather undelivered tasks next round "
                         "(reissue needs --adaptive)")
    ap.add_argument("--dead-after", type=int, default=None,
                    help="adaptive crash detection: presume a worker dead "
                         "after this many consecutive rounds with no "
                         "delivery")
    ap.add_argument("--persistence", type=float, default=0.9,
                    help="straggler persistence (markov) / AR(1) rho")
    ap.add_argument("--spread", type=float, default=2.0,
                    help="worker speed heterogeneity (geometric spread)")
    ap.add_argument("--p-slow", type=float, default=0.2)
    ap.add_argument("--slow", type=float, default=5.0)
    ap.add_argument("--mesh", default="local",
                    help="'local' (one device); meshes over several cards "
                         "are refused")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    return ap


def _round_config(args, seeds) -> RoundConfig:
    """Every round field through ``RoundConfig``'s one validation path,
    from the flags or from ``--config``."""
    try:
        if args.config:
            rc = RoundConfig.load(args.config)
            args.n, args.k, args.schedule = rc.n, rc.k, rc.kind
            args.r = rc.width
            args.adaptive = rc.adaptive
            args.deadline = rc.deadline
            args.deadline_policy = rc.deadline_policy
            args.dead_after = rc.dead_after
            return rc
        loads = (tuple(int(v) for v in args.loads.split(","))
                 if args.loads else None)
        return RoundConfig(
            n=args.n, k=args.k, kind=args.schedule,
            r=args.n if args.schedule == "ra" else args.r, loads=loads,
            deadline=args.deadline, deadline_policy=args.deadline_policy,
            adaptive=args.adaptive, dead_after=args.dead_after,
            seed=seeds["schedule_seed"])
    except ValueError as e:
        raise SystemExit(str(e))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> TrainResult:
    args = _parser().parse_args(argv)
    if args.mesh != "local":
        raise SystemExit(
            f"--mesh {args.mesh}: the reference builds its 256 / 512-card "
            f"mesh here, which one card cannot hold; the CLI trains on one "
            f"device (a mesh step runs through train.make_straggler_train_"
            f"step under sharding.mesh_context, the state placed by "
            f"launch.shardings.distribute_train_state; real multi-card "
            f"runs are ROADMAP.md item 8.8 (c))")
    cfg = cli_config(args.arch, args.smoke)
    if cfg.frontend_seq or cfg.encoder_layers:
        # the reference's refusal (repro/launch/train.py:198-200)
        raise SystemExit("use text archs for this launcher; whisper and "
                         "llava training go through train.make_straggler_"
                         "train_step with extras={'enc_frames': ...} or "
                         "{'embeds': ...}")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        need = state_bytes(cfg)
        have = torch.cuda.get_device_properties(dev).total_memory
        if need > have:
            raise SystemExit(
                f"{cfg.name}: {need} bytes of weights, gradients and AdamW "
                f"moments exceed the {have} bytes of one card (training "
                f"over several cards is ROADMAP.md item 8.8 (c))")
    if args.log_delays:
        # fail fast on an unwritable destination
        out_dir = os.path.dirname(os.path.abspath(args.log_delays))
        os.makedirs(out_dir, exist_ok=True)
        if not os.access(out_dir, os.W_OK):
            raise SystemExit(f"--log-delays: cannot write to {out_dir}")
    seeds = dict(derive_seeds(args.seed))
    # the port's integer seeds of the two key streams (second words)
    seeds["init_seed"] = int(seeds["init_key"][1])
    seeds["delay_seed"] = int(seeds["delay_root"][1])
    rc = _round_config(args, seeds)
    if rc.rebalance:
        raise SystemExit("load re-balancing has no training step")
    delay = build_cluster(args, seeds)
    part = TaskPartition(n=rc.n, global_batch=args.batch,
                         seq_len=args.seq, vocab=cfg.vocab_size,
                         source="bigram", seed=seeds["data_seed"])
    part.task_batch                                  # validates the split
    opt = adamw(cosine_schedule(args.lr, args.steps, warmup=5))

    state = init_train_state(cfg, opt, seed=seeds["init_seed"], device=dev)
    start = 0
    if args.resume and args.ckpt_dir:
        path = latest_checkpoint(args.ckpt_dir, args.arch)
        if path:
            state.load_tree(load_checkpoint(path, state.tree()))
            start = state.step
            print(f"resumed from {path} at step {start}")
    loads = rc.loads
    print(f"{cfg.name}: {num_params(state.params):,} params | "
          f"round n={rc.n} r={rc.width} k={rc.k} {args.schedule}"
          f"{'+adaptive' if args.adaptive else ''}"
          f"{' loads=' + ','.join(map(str, loads)) if loads else ''} | "
          f"cluster {args.cluster}"
          f"{' +' + args.scenario if args.scenario != 'none' else ''}"
          f"{f' deadline={args.deadline:g}/{args.deadline_policy}' if args.deadline is not None else ''}"
          f" | {dev}")
    if isinstance(delay, TraceProcess) and start:
        # a resumed run keeps its remaining steps on the trace rounds those
        # steps originally consumed
        delay = dataclasses.replace(delay, start_round=start)
    # fail fast (with the remedy) instead of rounds into the run
    as_process(delay).check_rounds(args.steps - start)
    step_fn = make_straggler_train_step(cfg, opt, rc, delay)
    base_C = rc.to_matrix()
    sched_kw = ({} if args.dead_after is None
                else {"dead_after": args.dead_after, "target_k": rc.k})
    sched = (AdaptiveScheduler(base_C, device=dev, **sched_kw)
             if args.adaptive else None)
    cluster = None
    vclock = 0.0
    missed = 0
    realized_sum = 0.0
    history: List[dict] = []
    step_s: List[float] = []
    logged_t1, logged_t2 = [], []
    t0 = time.time()
    for i in range(start, args.steps):
        _sync(dev)
        ts = time.perf_counter()
        before = dict(ops.LAUNCHES)
        C = base_C if sched is None else sched.matrix()
        row = None if sched is None else sched.row_of_worker()
        toks, labs = lm_task_batches(part, C, i, device=dev)
        state, m, cluster = step_fn(state, toks, labs, seeds["delay_seed"],
                                    cluster, row)
        m = {key: v.detach().cpu().numpy() for key, v in m.items()}
        if sched is not None:
            sched.observe(m["worker_t1"])
            if args.deadline_policy == "reissue":
                # undelivered tasks get re-gather priority next round
                sched.set_need(~m["delivered_tasks"])
        _sync(dev)
        step_s.append(time.perf_counter() - ts)
        if args.log_delays:
            logged_t1.append(m["slot_t1"])
            logged_t2.append(m["slot_t2"])
        vclock += float(m["completion_time"])
        missed += int(bool(m["deadline_missed"]))
        realized_sum += float(m["realized_k"])
        history.append({
            "step": i, "loss": float(m["loss"]), "aux": float(m["aux"]),
            "grad_norm": float(m["grad_norm"]),
            "completion_time": float(m["completion_time"]),
            "winners": int(m["winners"]), "realized_k": float(m["realized_k"]),
            "deadline_missed": bool(m["deadline_missed"]),
            "delivered_tasks": m["delivered_tasks"].tolist(),
            "weights": m["weights"].tolist(),
            "row_of_worker": None if row is None else row.tolist(),
            "launches": {k: ops.LAUNCHES[k] - before[k] for k in before}})
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            print(f"step {i:5d}  loss {float(m['loss']):.4f}  "
                  f"gnorm {float(m['grad_norm']):.3f}  "
                  f"vclock {vclock * 1e3:.2f} ms")
    rounds_run = args.steps - start
    print(f"done: {rounds_run} rounds in "
          f"{time.time() - t0:.1f}s wall, {vclock * 1e3:.2f} ms virtual")
    if args.deadline is not None and rounds_run:
        print(f"deadline {args.deadline:g}s/{args.deadline_policy}: "
              f"{missed}/{rounds_run} rounds missed, mean realized k "
              f"{realized_sum / rounds_run:.2f}/{rc.k}")
    trace_path = None
    if args.log_delays and logged_t1:
        trace = DelayTrace(
            np.stack(logged_t1), np.stack(logged_t2),
            meta={"source": "repro_torch.launch.train", "arch": args.arch,
                  "schedule": args.schedule, "cluster": args.cluster,
                  "n": rc.n, "r": rc.width, "k": rc.k, "seed": args.seed,
                  "start_step": start, "adaptive": bool(args.adaptive)})
        trace_path = save_trace(args.log_delays, trace)
        print(f"logged {trace.rounds} rounds of delays -> {trace_path} "
              f"(replay with --cluster trace --trace {trace_path})")
    ckpt_path = None
    if args.ckpt_dir:
        ckpt_path = save_checkpoint(f"{args.ckpt_dir}/{args.arch}",
                                    state.tree(), step=args.steps)
        print("saved", ckpt_path)
    return TrainResult(state, history, step_s, start, trace_path, ckpt_path,
                       seeds)


if __name__ == "__main__":
    main()
