"""Racing-planner CLI of the port: find a grid's argmin operating point by
successive halving with paired elimination (``repro_torch.core.planner``)
instead of streaming the exhaustive grid, and write the versioned
plan-result artifact (the JAX package's schema:
``repro.core.planner.PlanResult.load`` reads it too); counterpart of
``repro.launch.plan``.

The search space is the ``GridSpec`` the grid CLI takes, as a JSON
document (``--spec``) or as inline axes:

  PYTHONPATH=src python -m repro_torch.launch.plan --n 16 \\
      --families cs ss ra pc --loads 2 4 8 16 --messages none 2 \\
      --trials 100000 --k 16 --out out/plan_result.json \\
      --emit-config out/round_config.json

It runs on the CUDA card unless given ``--device cpu``; ``--devices N``
shards the racing sweeps as the grid CLI does.  ``--emit-config`` also
writes the winner's ``RoundConfig`` JSON when the winner is a TO-matrix
family (cs / ss / ra); ``RoundConfig.load`` of either package reads it.
``--trials`` is the last rung's count, so the argmin carries the exhaustive grid's
confidence at that budget.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from ..core.grid import GridSpec
from ..core.planner import plan
from ..sharding import cli_devices
from .grid import _axis, _build_model, add_common_args


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.plan",
        description="Race a scheme/load/budget grid to its argmin "
                    "operating point and write a versioned plan-result "
                    "artifact.")
    add_common_args(ap)
    ap.add_argument("--trials", type=int, default=20000,
                    help="final-rung (= exhaustive-equivalent) trials")
    ap.add_argument("--k", type=int, default=None,
                    help="computation target (default: n)")
    ap.add_argument("--base-trials", type=int, default=None,
                    help="first-rung trials (default trials/eta^3, >= 256)")
    ap.add_argument("--eta", type=int, default=4, help="rung growth factor")
    ap.add_argument("--z", type=float, default=3.0,
                    help="elimination threshold in paired-gap sigmas")
    ap.add_argument("--no-theory-prune", action="store_true",
                    help="skip the closed-form dominance pruning stage")
    ap.add_argument("--emit-config", default=None,
                    help="also write the winning RoundConfig JSON here "
                         "(TO-matrix winners only)")
    ap.add_argument("--out", default="out/plan_result.json",
                    help="artifact path (directories are created)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = cli_devices(args.device, args.devices)
    if args.spec is not None:
        with open(args.spec) as fh:
            gs = GridSpec.from_json(json.load(fh))
    else:
        gs = GridSpec(n=args.n, families=tuple(args.families),
                      loads=tuple(args.loads),
                      messages=_axis(args.messages, int),
                      comm_eps=tuple(args.eps), ks=(None,),
                      trials=args.trials, seed=args.seed, chunk=args.chunk)
    model = _build_model(args.model, gs.n, gs.seed)
    print(f"plan: racing grid n={gs.n} "
          f"(final rung {gs.trials:,} trials/point, model={args.model}, "
          f"device={device})", flush=True)

    res = plan(gs, model, k=args.k, base_trials=args.base_trials,
               eta=args.eta, z=args.z,
               theory_prune=not args.no_theory_prune, devices=device)
    res.meta["model"] = args.model
    res.meta["spec"] = gs.to_json()

    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    res.save(args.out)

    m = res.meta
    print(f"done: {m['raced_points']} raced / {m['theory_pruned']} pruned "
          f"/ {m['excluded']} excluded of {m['exhaustive_cells']} cells "
          f"in {m['seconds']:.2f}s")
    print(f"winner: {res.winner} mean {res.predicted_mean:.6g} "
          f"+- {res.predicted_stderr:.2g}")
    if res.lb_gap is not None:
        print(f"vs oracle LB: {res.lb_mean:.6g} (+{100 * res.lb_gap:.1f}%)")
    if m["ties"]:
        print(f"ties within {m['z']} sigma: {', '.join(m['ties'])}")
    print(f"trials: {res.trials_spent:,} spent vs "
          f"{res.exhaustive_trials:,} exhaustive ({res.savings:.1f}x saved)")
    if res.config is not None:
        if args.emit_config:
            cfg_dir = os.path.dirname(args.emit_config)
            if cfg_dir:
                os.makedirs(cfg_dir, exist_ok=True)
            res.config.save(args.emit_config)
            print(f"round config: {args.emit_config}")
    elif res.config_note:
        print(f"round config: none ({res.config_note})")
        if args.emit_config:
            print(f"(--emit-config {args.emit_config} skipped)")
    print(f"artifact: {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
