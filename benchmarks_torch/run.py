"""Benchmark harness of the PyTorch port -- one entry per paper table or
figure ported so far; counterpart of ``benchmarks/run.py``.

Prints ``name,us_per_call,derived`` CSV rows:
  fig3   delay-model calibration (comm >> comp)
  fig4   avg completion vs r, truncated-Gaussian scenarios 1 & 2 (n=16)
  fig5   avg completion vs r, EC2-calibrated model (n=15)
  fig6   avg completion vs n (r=n)
  fig7   avg completion vs k (n=10, r=n)
  fig8   rounds-axis wall-clock: persistence x heterogeneity grid, static
         CS/SS vs feedback-adaptive row assignment vs oracle LB (exits
         non-zero unless adapt beats CS/SS on the persistent heterogeneous
         cell)
  fig9   intra-round message budget m in {1, 2, r} for CS/SS/PCMM and the
         per-message overhead panel (exits non-zero if multi-message stops
         beating single-message or the optimal budget degenerates)
  fig10  adaptive load re-balancing vs row re-permutation (exits non-zero
         unless re-balancing beats static CS/SS and permutation-only
         adaptation)
  fig11  trace record -> replay -> calibrate (exits non-zero if replay
         diverges or the calibrated margin's sign flips; writes the trace
         into --out)
  fig12  fault injection and graceful degradation: the scenario zoo under a
         round deadline (exits non-zero if adaptation stops paying under
         preemption, a scenario deadlocks, or fault-trace replay diverges;
         writes the trace into --out)
  grid   streaming grid sweep (64 cells, n=16) vs a loop of per-cell sweeps
         (exits non-zero unless the streamed cells are bit-equal to the
         per-cell path and the grid builds one evaluator per shape bucket;
         writes GRID_result.json into --out)
  planner  racing planner vs the exhaustive grid (exits non-zero unless
         both name the same winner with consistent means)
  fig13  the live master-worker cluster vs the engine: bit-exact per-round
         times and trace replay, the live mean within the Monte-Carlo
         prediction's tolerance, deadline accounting equal to the engine's
         degradation streams (exits non-zero on any violation)
  mc_engine  fused sweep-engine throughput vs the seed-style per-scheme path
  table1 one DGD iteration per scheme incl. real PC/PCMM decode (the rows'
         ``ok`` hold each update error to its bound)

Each job also writes ``BENCH_<name>.json`` (the rows with parsed derived
metrics) into ``--out``.  Every job's rows are screened for NaN/inf metric
values: a non-finite number aborts the harness with a non-zero exit.
``python -m benchmarks_torch.regression_gate`` holds the artifacts to the
port's baseline.  The reference's roofline job waits for a later slice of
the port: asking for it exits non-zero and names its ``ROADMAP.md`` item.

Run from the repository root (``--device cuda``, the default, needs a card):

    python -m benchmarks_torch.run --quick [--only fig4,fig7] [--device cpu]

``--quick`` takes 4000 Monte-Carlo trials a grid point instead of 20000.
"""
import argparse
import json
import math
import os
import time

#: the reference's jobs that wait for a later slice, and the ROADMAP.md
#: item each waits for
LATER = {
    "roofline": "queue 1 item 8 (the rest of the LM stack)",
}


def _check_finite(name: str, rows: list) -> None:
    """Fail loudly (non-zero exit) when a benchmark emits NaN/inf metrics."""
    bad = [(row["name"], key, val)
           for row in rows for key, val in row.get("derived", {}).items()
           if isinstance(val, float) and not math.isfinite(val)]
    if bad:
        lines = "; ".join(f"{r}:{k}={v}" for r, k, v in bad)
        raise SystemExit(
            f"benchmarks_torch.run: benchmark {name!r} emitted non-finite "
            f"metric(s): {lines} -- refusing to report poisoned results")


def main(argv=None) -> dict:
    """Run the jobs; returns ``{job: {"seconds": wall s, "rows": rows}}``.
    A failed guard raises ``SystemExit``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="fewer Monte-Carlo trials")
    ap.add_argument("--only", default=None,
                    help="comma-separated subset, e.g. fig4,fig7")
    ap.add_argument("--out", default="bench_out_torch",
                    help="directory for BENCH_<name>.json artifacts "
                         "(created if needed; '' disables JSON output)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; no CPU fallback) or cpu")
    args = ap.parse_args(argv)
    trials = 4000 if args.quick else 20000
    only = set(args.only.split(",")) if args.only else None
    dev = args.device

    from . import (common, fig3_delays, fig4_vs_load, fig5_ec2,
                   fig6_vs_workers, fig7_vs_target, fig8_convergence,
                   fig9_multimessage, fig10_load_rebalance,
                   fig11_trace_replay, fig12_faults, fig13_live,
                   grid_stream,
                   mc_engine, planner, table1_e2e)

    jobs = {
        "fig3": lambda: fig3_delays.run(trials, dev),
        "fig4": lambda: fig4_vs_load.run(trials, dev),
        "fig5": lambda: fig5_ec2.run(trials, dev),
        "fig6": lambda: fig6_vs_workers.run(trials, dev),
        "fig7": lambda: fig7_vs_target.run(trials, dev),
        "fig8": lambda: fig8_convergence.run(trials, dev),
        "fig9": lambda: fig9_multimessage.run(trials, dev),
        "fig10": lambda: fig10_load_rebalance.run(trials, dev),
        "fig11": lambda: fig11_trace_replay.run(
            trials, dev, out=args.out or "bench_out_torch"),
        "fig12": lambda: fig12_faults.run(
            trials, dev, out=args.out or "bench_out_torch"),
        "grid": lambda: grid_stream.run(trials, dev, out=args.out),
        "planner": lambda: planner.run(trials, dev),
        "fig13": lambda: fig13_live.run(trials, dev),
        "mc_engine": lambda: mc_engine.run(trials, dev),
        "table1": lambda: table1_e2e.run(dev),
    }
    if only:
        later = sorted(only & set(LATER))
        if later:
            raise SystemExit(
                "benchmarks_torch.run: not ported yet: " + "; ".join(
                    f"{name} waits for ROADMAP.md {LATER[name]}"
                    for name in later))
        unknown = sorted(only - set(jobs))
        if unknown:
            raise SystemExit(
                f"benchmarks_torch.run: unknown --only name(s) {unknown}; "
                f"valid names: {sorted(jobs)}")

    print("name,us_per_call,derived", flush=True)
    done = {}
    for name, job in jobs.items():
        if only and name not in only:
            continue
        common.drain_rows()            # drop strays from earlier jobs
        t0 = time.perf_counter()
        try:
            job()
        finally:
            # write the artifact even when a guard fails: the rows are the
            # diagnosis
            secs = time.perf_counter() - t0
            rows = common.drain_rows()
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                path = os.path.join(args.out, f"BENCH_{name}.json")
                with open(path, "w") as f:
                    json.dump({"bench": name, "quick": bool(args.quick),
                               "trials": trials, "device": dev,
                               "seconds": secs, "unix_time": time.time(),
                               "rows": rows}, f, indent=2)
                    f.write("\n")
        _check_finite(name, rows)
        done[name] = {"seconds": secs, "rows": rows}
    return done


if __name__ == "__main__":
    main()
