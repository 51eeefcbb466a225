"""Live cluster launcher of the port: a real async master + workers over
inproc/TCP; counterpart of ``repro.launch.live``.

Three subcommands, all driven by ONE serialized ``RoundConfig`` document
(``RoundConfig.save("round.json")``; either package's document reads in
both):

  # single-process demo cluster (master + n in-process workers)
  PYTHONPATH=src python -m repro_torch.launch.live local \\
      --config round.json --rounds 20 --cluster markov --save-trace run.npz

  # distributed: master listens, workers connect (one per machine)
  PYTHONPATH=src python -m repro_torch.launch.live master \\
      --config round.json --rounds 50 --listen tcp://0.0.0.0:5555
  PYTHONPATH=src python -m repro_torch.launch.live worker \\
      --config round.json --connect tcp://master-host:5555 --cluster markov

Every subcommand runs on the CUDA card unless given ``--device cpu`` (the
master scores rounds and schedules there, a worker draws its delay tables
there); without a card the default raises.  The wire format is the JAX
package's, so a ``repro.launch.live`` master serves these workers and the
other way round.

Workers draw their virtual delays from the same shared-seed tables the
engine would (the config's ``seed``), so the recorded trace replays
bit-exactly through ``sweep_rounds`` — the live run IS a realization of
the simulated process.  ``--time-scale`` maps virtual delay units to wall
seconds (0 = as fast as possible); ``--no-abort`` makes workers finish
every round even after it closed (dense tables for analysis).
"""
from __future__ import annotations

import argparse
import asyncio
import json

from ..core import FAULT_SCENARIOS, RoundConfig, save_trace
from ..device import resolve_device
from ..live import Master, listen, run_live, run_worker
from .cluster import build_cluster, derive_seeds


def _add_cluster_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--cluster", default="iid",
                    choices=("iid", "markov", "ar1", "trace"))
    ap.add_argument("--trace", default=None,
                    help="delay-trace file for --cluster trace")
    ap.add_argument("--trace-pad", default="error",
                    choices=("error", "cycle", "hold"))
    ap.add_argument("--straggle", action="store_true")
    ap.add_argument("--scenario", default="none",
                    choices=("none",) + FAULT_SCENARIOS)
    ap.add_argument("--persistence", type=float, default=0.9)
    ap.add_argument("--spread", type=float, default=2.0)
    ap.add_argument("--p-slow", type=float, default=0.2)
    ap.add_argument("--slow", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="root seed for the cluster-process construction "
                         "streams (the delay draws themselves come from "
                         "the config's seed)")


def _add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; no CPU fallback) or cpu")


def _add_run_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--config", required=True, metavar="PATH",
                    help="serialized RoundConfig JSON document")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--time-scale", type=float, default=0.0,
                    help="wall seconds per virtual delay unit (0 = run as "
                         "fast as possible)")
    ap.add_argument("--no-abort", action="store_true",
                    help="workers finish every round even after it closes "
                         "(dense recorded tables)")
    ap.add_argument("--save-trace", default=None, metavar="PATH",
                    help="write the recorded delay trace (.npz)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write a JSON run summary")
    _add_device_arg(ap)


def _process_for(args, cfg: RoundConfig):
    ns = argparse.Namespace(**vars(args))
    ns.n = cfg.n
    return build_cluster(ns, derive_seeds(args.seed))


def _finish(result, args) -> None:
    print(f"rounds={len(result.per_round)} mean={result.mean:.6g} "
          f"missed={int(result.missed.sum())} "
          f"realized_k={result.realized.mean():.3g} "
          f"trace={result.trace!r}")
    if args.save_trace:
        path = save_trace(args.save_trace, result.trace)
        print(f"trace -> {path}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"config": result.config.to_dict(),
                       "per_round": result.per_round.tolist(),
                       "realized": result.realized.tolist(),
                       "missed": result.missed.astype(int).tolist(),
                       "mean": result.mean,
                       "trace_digest": result.trace.header()["digest"]},
                      f, indent=2)
        print(f"summary -> {args.out}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.live",
        description="Live async master-worker round execution.")
    sub = ap.add_subparsers(dest="mode", required=True)

    ap_local = sub.add_parser("local", help="master + n in-process workers")
    _add_run_args(ap_local)
    _add_cluster_args(ap_local)
    ap_local.add_argument("--address", default=None,
                          help="optional explicit address (e.g. "
                               "tcp://127.0.0.1:0 to exercise TCP)")

    ap_master = sub.add_parser("master", help="listen and drive rounds")
    _add_run_args(ap_master)
    ap_master.add_argument("--listen", required=True, metavar="ADDRESS",
                           help="e.g. tcp://0.0.0.0:5555")

    ap_worker = sub.add_parser("worker", help="connect and serve rounds")
    ap_worker.add_argument("--config", required=True, metavar="PATH",
                           help="the same RoundConfig document the master "
                                "uses (drives the shared-seed delay draws)")
    ap_worker.add_argument("--connect", required=True, metavar="ADDRESS",
                           help="master address, e.g. tcp://host:5555")
    _add_cluster_args(ap_worker)
    _add_device_arg(ap_worker)

    args = ap.parse_args(argv)
    try:
        cfg = RoundConfig.load(args.config)
    except ValueError as e:
        raise SystemExit(str(e))
    device = resolve_device(args.device)
    # delays are drawn by the WORKERS (shared-seed tables); the master
    # only scores what arrives, so it needs no cluster model at all
    process = None if args.mode == "master" else _process_for(args, cfg)

    if args.mode == "local":
        result = run_live(cfg, process, args.rounds, address=args.address,
                          time_scale=args.time_scale,
                          abort_on_close=not args.no_abort, device=device)
        _finish(result, args)
    elif args.mode == "master":
        async def _serve():
            listener = await listen(args.listen)
            print(f"listening on {listener.address} for {cfg.n} workers",
                  flush=True)
            try:
                master = Master(cfg, rounds=args.rounds, listener=listener,
                                time_scale=args.time_scale,
                                abort_on_close=not args.no_abort,
                                device=device)
                return await master.run()
            finally:
                await listener.aclose()
        result = asyncio.run(_serve())
        _finish(result, args)
    else:
        asyncio.run(run_worker(args.connect, process, device=device))
        print("worker done")


if __name__ == "__main__":
    main()
