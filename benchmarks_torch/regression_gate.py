"""Benchmark-regression gate of the PyTorch port; counterpart of
``benchmarks/regression_gate.py`` (the same checks, tolerances, ``--only``
and exit codes).

Compares the ``BENCH_<name>.json`` files that ``python -m
benchmarks_torch.run --out`` writes (default ``bench_out_torch/``) against
the port's own baseline, ``benchmarks_torch/baselines/
bench_quick_baseline.json``:

* ``mc_engine`` -- the fused engine's throughput (``mc_engine/fused``) at
  or above ``--throughput-tol`` x the baseline, a low-water mark from a card
  run of ``run.py --quick``: a structural guard (a lost evaluator cache,
  an un-fused evaluation), not a jitter one.
* ``fig8`` -- the adaptive-vs-static margin on the persistent
  heterogeneous cell at or above the baseline less ``--margin-drop``
  percentage points (and above zero): scheduler quality, independent of
  the machine.
* ``fig10`` -- the load-rebalancing-vs-permutation margin, within
  ``--rebal-drop`` points of the baseline.
* ``fig11`` -- the adaptive-vs-static margin on the recorded trace, within
  ``--trace-drop`` points.
* ``fig12`` -- the adaptive-vs-static margin in time per realized result
  under spot preemption with a deadline (``close_partial``), within
  ``--fault-drop`` points.
* ``fig13`` -- the live cluster against the engine: the bit-exact legs
  report PASS and the live-vs-MC relative error stays below
  ``fig13_live_rel_err_max``.
* ``planner`` -- ``planner/agreement`` reports ``agree=1`` and the race
  saves at least ``planner_trials_saved_min`` x in trial-evaluations.
* ``grid`` -- cells/s at or above ``--grid-tol`` x the baseline (a card
  low-water mark), the stream-over-naive speedup at or above
  ``grid_speedup_min``, no more evaluator builds than shape buckets, and
  the benchmark's own bit-exactness leg PASS.
* ``scaling`` (opt-in through ``--only``) -- the ``mc_engine/scaling`` row
  of a multi-device run: its strong speedup at or above ``--scaling-tol`` x
  ``mc_engine_strong_speedup``, and ``trials_per_sec``, ``strong_speedup``
  and ``weak_efficiency`` present and finite.  The baseline holds no
  ``mc_engine_strong_speedup`` until a run on several cards writes one;
  without it the check exits 2 and says so.

``--only`` selects the checks (default: all but ``scaling``).  Every
numeric derived field of every file read must be finite: a NaN or an inf
anywhere fails the gate.

Exit codes: 0 every check passed, 1 a regression or a non-finite metric, 2
a missing input (a file, a row, a field or a baseline value).

Usage, from the repository root, on the card::

    python -m benchmarks_torch.run --quick --only mc_engine,grid,planner,fig8,fig10,fig11,fig12,fig13
    python -m benchmarks_torch.regression_gate --results bench_out_torch
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__), "baselines",
                                "bench_quick_baseline.json")
CHECKS = ("mc_engine", "grid", "planner", "scaling", "fig8", "fig10",
          "fig11", "fig12", "fig13")
DEFAULT_ONLY = ",".join(c for c in CHECKS if c != "scaling")


class _Missing(Exception):
    """An input the gate needs is absent (exit code 2)."""


class _NonFinite(Exception):
    """A file carries a NaN or an inf (exit code 1)."""


def _load_bench(results_dir: str, bench: str) -> dict:
    path = os.path.join(results_dir, f"BENCH_{bench}.json")
    if not os.path.exists(path):
        raise _Missing(f"missing {path} (run python -m benchmarks_torch.run "
                       f"--only {bench} --out {results_dir} first)")
    with open(path) as f:
        payload = json.load(f)
    bad = [(row.get("name"), key, val)
           for row in payload.get("rows", [])
           for key, val in row.get("derived", {}).items()
           if isinstance(val, float) and not math.isfinite(val)]
    if bad:
        lines = "; ".join(f"{r}:{k}={v}" for r, k, v in bad)
        raise _NonFinite(f"BENCH_{bench}.json carries non-finite metric(s): "
                         f"{lines}")
    return payload


def _row(payload: dict, name: str) -> dict:
    for row in payload.get("rows", []):
        if row.get("name") == name:
            return row["derived"]
    raise _Missing(f"BENCH_{payload.get('bench')}.json has no row {name!r}")


def _number(derived: dict, row: str, field: str) -> float:
    val = derived.get(field)
    if not isinstance(val, (int, float)) or isinstance(val, bool):
        raise _Missing(f"{row} row lacks a numeric {field!r} derived field")
    return val


def _baseline(base: dict, key: str) -> float:
    if key not in base:
        raise _Missing(f"the baseline has no {key!r}")
    return base[key]


def _margin(args, base, bench, row, field, key, drop, what) -> bool:
    """A percentage margin against its baseline less ``drop`` points."""
    margin = _number(_row(_load_bench(args.results, bench), row), row, field)
    floor = max(_baseline(base, key) - drop, 0.0)
    ok = margin >= floor
    print(f"{'PASS' if ok else 'FAIL'} {what}: {margin:+.1f}% (floor "
          f"{floor:+.1f}% = baseline {base[key]:+.1f}% - {drop})")
    return ok


def _check_mc_engine(args, base) -> bool:
    thr = _number(_row(_load_bench(args.results, "mc_engine"),
                       "mc_engine/fused"), "mc_engine/fused", "throughput")
    ref = _baseline(base, "mc_engine_fused_throughput")
    floor = ref * args.throughput_tol
    ok = thr >= floor
    print(f"{'PASS' if ok else 'FAIL'} mc_engine fused throughput: "
          f"{thr:,.0f} trials*schemes/s (floor {floor:,.0f} = "
          f"{args.throughput_tol} x baseline {ref:,.0f})")
    return ok


def _check_grid(args, base) -> bool:
    grid = _load_bench(args.results, "grid")
    stream, spd = _row(grid, "grid/stream"), _row(grid, "grid/speedup")
    cps = _number(stream, "grid/stream", "cells_per_sec")
    speedup = _number(spd, "grid/speedup", "stream_over_naive")
    builds = _number(stream, "grid/stream", "compiles")
    buckets = _number(stream, "grid/stream", "buckets")
    ref = _baseline(base, "grid_cells_per_sec")
    floor, spd_floor = ref * args.grid_tol, _baseline(base,
                                                      "grid_speedup_min")
    ok = (cps >= floor and speedup >= spd_floor and builds <= buckets
          and spd.get("bitexact") == "PASS")
    print(f"{'PASS' if ok else 'FAIL'} grid streaming engine: {cps:.2f} "
          f"cells/s (floor {floor:.2f} = {args.grid_tol} x baseline "
          f"{ref:.2f}), speedup {speedup}x (floor {spd_floor}x), "
          f"builds={builds:g} for buckets={buckets:g}, "
          f"bitexact={spd.get('bitexact')}")
    return ok


def _check_planner(args, base) -> bool:
    pl = _load_bench(args.results, "planner")
    race, agreement = _row(pl, "planner/race"), _row(pl, "planner/agreement")
    saved = _number(race, "planner/race", "saved")
    floor = _baseline(base, "planner_trials_saved_min")
    agree = agreement.get("agree")
    ok = agree == 1 and saved >= floor
    print(f"{'PASS' if ok else 'FAIL'} planner racing: agree={agree} "
          f"(planner={agreement.get('planner')}, "
          f"exhaustive={agreement.get('exhaustive')}), trial-evaluations "
          f"saved {saved}x (floor {floor}x)")
    return ok


def _check_scaling(args, base) -> bool:
    row = _row(_load_bench(args.results, "mc_engine"), "mc_engine/scaling")
    for field in ("trials_per_sec", "strong_speedup", "weak_efficiency",
                  "devices"):
        _number(row, "mc_engine/scaling", field)
    if "mc_engine_strong_speedup" not in base:
        raise _Missing("the baseline has no 'mc_engine_strong_speedup': no "
                       "run on several cards has written one yet")
    floor = base["mc_engine_strong_speedup"] * args.scaling_tol
    ok = row["strong_speedup"] >= floor
    print(f"{'PASS' if ok else 'FAIL'} mc_engine sharded strong speedup "
          f"({row['devices']:.0f} devices, {row.get('device_list')}): "
          f"{row['strong_speedup']:.2f}x (floor {floor:.2f}x = "
          f"{args.scaling_tol} x baseline "
          f"{base['mc_engine_strong_speedup']:.1f}x; weak efficiency "
          f"{row['weak_efficiency']:.2f}, {row['trials_per_sec']:,.0f} "
          f"trials/s)")
    return ok


def _check_fig13(args, base) -> bool:
    fig13 = _load_bench(args.results, "fig13")
    exact, dl = _row(fig13, "fig13/exact"), _row(fig13, "fig13/deadline")
    rel = _number(_row(fig13, "fig13/accuracy"), "fig13/accuracy", "rel_err")
    tol = (args.live_tol if args.live_tol is not None
           else _baseline(base, "fig13_live_rel_err_max"))
    ok = (exact.get("status") == "PASS" and dl.get("status") == "PASS"
          and rel <= tol)
    print(f"{'PASS' if ok else 'FAIL'} fig13 live-vs-simulator: "
          f"exact={exact.get('status')} deadline={dl.get('status')} "
          f"rel_err={rel:.4f} (max {tol:g})")
    return ok


def _checks(args, base) -> dict:
    """Check name -> a function that prints its line and returns pass."""
    return {
        "mc_engine": lambda: _check_mc_engine(args, base),
        "grid": lambda: _check_grid(args, base),
        "planner": lambda: _check_planner(args, base),
        "scaling": lambda: _check_scaling(args, base),
        "fig8": lambda: _margin(
            args, base, "fig8", base.get("fig8_cell", "fig8/p0.98_s3"),
            "adapt_vs_static", "fig8_adapt_vs_static", args.margin_drop,
            f"fig8 adaptive-vs-static margin "
            f"({base.get('fig8_cell', 'fig8/p0.98_s3')})"),
        "fig10": lambda: _margin(
            args, base, "fig10", "fig10/rebalance", "rebal_vs_perm",
            "fig10_rebal_vs_perm", args.rebal_drop,
            "fig10 rebalance-vs-permutation margin"),
        "fig11": lambda: _margin(
            args, base, "fig11", "fig11/trace", "adapt_vs_static",
            "fig11_trace_adapt_vs_static", args.trace_drop,
            "fig11 trace-replay adaptive-vs-static margin"),
        "fig12": lambda: _margin(
            args, base, "fig12", "fig12/preemption", "adapt_vs_static",
            "fig12_fault_margin", args.fault_drop,
            "fig12 fault-tolerance adaptive-vs-static margin (preemption, "
            "close_partial)"),
        "fig13": lambda: _check_fig13(args, base),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m benchmarks_torch."
                                      "regression_gate")
    ap.add_argument("--results", default="bench_out_torch",
                    help="directory holding BENCH_<name>.json files")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="the port's baseline JSON")
    ap.add_argument("--throughput-tol", type=float, default=0.25,
                    help="fail if fused throughput < tol * baseline")
    ap.add_argument("--margin-drop", type=float, default=6.0,
                    help="max drop (percentage points) of the fig8 "
                         "adaptive-vs-static margin vs baseline")
    ap.add_argument("--rebal-drop", type=float, default=2.0,
                    help="max drop (percentage points) of the fig10 "
                         "rebalance-vs-permutation margin vs baseline")
    ap.add_argument("--trace-drop", type=float, default=6.0,
                    help="max drop (percentage points) of the fig11 "
                         "trace-replay margin vs baseline")
    ap.add_argument("--fault-drop", type=float, default=5.0,
                    help="max drop (percentage points) of the fig12 margin "
                         "under preemption vs baseline")
    ap.add_argument("--scaling-tol", type=float, default=0.75,
                    help="fail if the multi-device strong speedup < tol * "
                         "baseline (scaling check only)")
    ap.add_argument("--grid-tol", type=float, default=0.25,
                    help="fail if grid cells-per-second < tol * baseline")
    ap.add_argument("--live-tol", type=float, default=None,
                    help="max live-vs-MC relative mean error for fig13 "
                         "(default: the baseline's fig13_live_rel_err_max)")
    ap.add_argument("--only", default=DEFAULT_ONLY,
                    help="comma-separated subset of the checks; add "
                         "'scaling' for a run on several cards")
    return ap


def main(argv=None) -> int:
    """Run the checks; returns the exit code (0 pass, 1 regression or
    non-finite metric, 2 missing input)."""
    args = build_parser().parse_args(argv)
    only = [s.strip() for s in args.only.split(",") if s.strip()]
    unknown = sorted(set(only) - set(CHECKS))
    if unknown:
        print(f"regression_gate: unknown --only check(s) {unknown}; valid: "
              f"{sorted(CHECKS)}")
        return 2
    if not os.path.exists(args.baseline):
        print(f"regression_gate: missing baseline {args.baseline}")
        return 2
    with open(args.baseline) as f:
        base = json.load(f)
    checks = _checks(args, base)
    failures = []
    try:
        for name in CHECKS:
            if name in only and not checks[name]():
                failures.append(name)
    except _Missing as e:
        print(f"regression_gate: {e}")
        return 2
    except _NonFinite as e:
        print(f"regression_gate: {e}")
        return 1
    if failures:
        print(f"regression_gate: FAILED checks: {failures}")
        return 1
    print("regression_gate: all checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
