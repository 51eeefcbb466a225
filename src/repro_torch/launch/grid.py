"""Full-grid sweep CLI of the port: stream a (scheme family x load x message
budget x comm_eps x k) grid through the bucketed evaluators and write the
versioned grid-result artifact (``repro_torch.core.grid.GridResult``, the
JAX package's schema: ``repro.core.grid.GridResult.load`` reads it too);
counterpart of ``repro.launch.grid``.

The grid comes from a ``GridSpec``, as a JSON document (``--spec``, the
``GridSpec.to_json`` format) or as inline axes:

  PYTHONPATH=src python -m repro_torch.launch.grid --n 16 \\
      --families cs ss lb pc --loads 2 4 8 --messages none 2 4 \\
      --trials 1000000 --out out/grid_result.json

  PYTHONPATH=src python -m repro_torch.launch.grid --spec grid.json \\
      --model ec2 --device cpu

It runs on the CUDA card unless given ``--device cpu``.  ``--devices N``
shards the trial axis over the first N cards (``--device cuda``) or over N
blocks on the named device (``--device cpu --devices 4``), bit-equal to one
device.
``--window`` (alias ``--pipeline``) sets how many fused dispatches stay in
flight (2: double buffering).  The racing planner (``python -m
repro_torch.launch.plan``) finds the same winner without streaming the
whole grid.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from ..core.delays import ec2_like, scenario1, scenario2
from ..core.grid import FAMILIES, GridSpec, stream_grid
from ..core.montecarlo import cache_stats
from ..sharding import cli_devices

MODELS = ("scenario1", "scenario2", "ec2")


def _build_model(name: str, n: int, seed: int):
    if name == "scenario1":
        return scenario1()
    if name == "scenario2":
        return scenario2(n, seed=seed)
    if name == "ec2":
        return ec2_like(n, seed=seed)
    raise SystemExit(f"unknown --model {name!r}; have {MODELS}")


def _axis(vals, cast):
    """Parse an axis list where the token ``none`` means None."""
    return tuple(None if str(v).lower() == "none" else cast(v) for v in vals)


def add_common_args(ap: argparse.ArgumentParser) -> None:
    """The grid axes and run options the grid and plan CLIs share."""
    ap.add_argument("--spec", default=None,
                    help="GridSpec JSON file (overrides the inline axes)")
    ap.add_argument("--n", type=int, default=16, help="cluster size")
    ap.add_argument("--families", nargs="+", default=["cs", "ss", "lb", "pc"],
                    choices=list(FAMILIES), help="scheme families")
    ap.add_argument("--loads", nargs="+", type=int, default=[2],
                    help="computation loads r")
    ap.add_argument("--messages", nargs="+", default=["none"],
                    help="message budgets (int or 'none' = per-task)")
    ap.add_argument("--eps", nargs="+", type=float, default=[0.0],
                    help="per-message comm overheads")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=None)
    ap.add_argument("--model", default="scenario1", choices=list(MODELS))
    ap.add_argument("--devices", type=int, default=None,
                    help="shard trials over the first N cards (--device "
                         "cuda) or N blocks on the named device")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu on request)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.grid",
        description="Stream a full scheme/load/budget grid and write a "
                    "versioned grid-result artifact.")
    add_common_args(ap)
    ap.add_argument("--ks", nargs="+", default=["none"],
                    help="computation targets (int or 'none' = all k)")
    ap.add_argument("--trials", type=int, default=20000)
    ap.add_argument("--window", "--pipeline", dest="window", type=int,
                    default=2,
                    help="streaming window: fused dispatches kept in "
                         "flight (2 = double buffering; --pipeline is an "
                         "alias)")
    ap.add_argument("--k", type=int, default=None,
                    help="computation target for the winner report "
                         "(defaults to each cell's ks, else n)")
    ap.add_argument("--out", default="out/grid_result.json",
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
                      comm_eps=tuple(args.eps), ks=_axis(args.ks, int),
                      trials=args.trials, seed=args.seed, chunk=args.chunk)
    model = _build_model(args.model, gs.n, gs.seed)
    cells = gs.cells(model)
    print(f"grid: {len(cells)} cells (n={gs.n}, trials={gs.trials:,}/cell, "
          f"model={args.model}, device={device})", flush=True)

    res = stream_grid(cells, devices=device, pipeline=args.window)
    res.meta["model"] = args.model
    res.meta["spec"] = gs.to_json()
    res.meta["window"] = args.window
    res.meta["cache"] = cache_stats()

    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    res.save(args.out)

    m = res.meta
    print(f"done: {m['cells']} cells in {m['seconds']:.2f}s "
          f"({m['cells_per_sec']:.2f} cells/s), "
          f"{m['fused_dispatches']} fused dispatches, "
          f"{m['buckets']} shape bucket(s), window {args.window}")
    try:
        best = res.best_cell(k=args.k)
        tie = f", {len(best['ties'])} tie(s) within 2 sigma" \
            if best["ties"] else ""
        print(f"best: {best['cell']} mean {best['mean']:.6g} "
              f"+- {best['stderr']:.2g}{tie}")
    except ValueError:
        pass        # rounds-only or lb-only grids have no scalar winner
    print(f"artifact: {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
