"""Fig. 8 on the PyTorch port: wall-clock convergence on round-aware
clusters — straggler persistence x worker heterogeneity; counterpart of
``benchmarks/fig8_convergence.py`` (same grid, rows and guard).

Sweeps the ``MarkovRegimeProcess`` grid (persistence in {0, 0.9, 0.98} x
speed spread in {1, 3}; N=12, R=3, K=9, 24 rounds, scenario-1 base) with
one ``sweep_rounds`` call per cell, every scheme on the same cluster
realizations: the static ``cs`` / ``ss`` schedules, ``adapt`` (greedy
feedback-driven row re-assignment of the CS matrix: the greedy_assign
kernel on the card) and the oracle lower bound ``lb``.  Prints
``fig8/p<persistence>_s<spread>,<us>,<derived>`` rows and exits non-zero
unless adapt beats both static schedules on the persistent heterogeneous
cell (0.98, 3).

Run:  PYTHONPATH=src python benchmarks_torch/fig8_convergence.py
          [--trials 8000] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (MarkovRegimeProcess, adaptive_spec,  # noqa: E402
                              cyclic_to_matrix, ec2_cluster, lb_spec,
                              scenario1, staircase_to_matrix, sweep_rounds,
                              to_spec)

N, R, K = 12, 3, 9
ROUNDS = 24
CHUNK = 2000
PERSISTENCE = (0.0, 0.9, 0.98)
SPREAD = (1.0, 3.0)


def cell_process(persistence: float, spread: float) -> MarkovRegimeProcess:
    return ec2_cluster(N, spread=spread, p_slow=0.25,
                       persistence=persistence, slow=8.0, base=scenario1(),
                       seed=1)


def specs():
    cs = cyclic_to_matrix(N, R)
    return [to_spec("cs", cs), to_spec("ss", staircase_to_matrix(N, R)),
            adaptive_spec("adapt", cs), lb_spec(R)]


def emit(name: str, us_per_call: float, derived: str) -> None:
    print(f"{name},{us_per_call:.1f},{derived}")


def run(trials: int = 20000, device=None):
    """The grid; returns ``{(persistence, spread): {scheme: ms/round}}``
    and the per-cell results, and raises ``SystemExit`` when the guard
    fails."""
    trials = min(trials, 8000)          # R*ROUNDS sims per trial
    sp = specs()
    out, results = {}, {}
    for p in PERSISTENCE:
        for s in SPREAD:
            t0 = time.perf_counter()
            res = sweep_rounds(sp, cell_process(p, s), N, rounds=ROUNDS,
                               k=K, trials=trials, seed=0,
                               chunk=min(CHUNK, trials), devices=device)
            secs = time.perf_counter() - t0
            ms = {x.name: res.mean_round(x.name) * 1e3 for x in sp}
            static = min(ms["cs"], ms["ss"])
            gain = 100.0 * (static - ms["adapt"]) / static
            emit(f"fig8/p{p}_s{s:g}", res.total("adapt") * 1e6,
                 f"trials={trials};rounds={ROUNDS};"
                 f"cs={ms['cs']:.4f}ms;ss={ms['ss']:.4f}ms;"
                 f"adapt={ms['adapt']:.4f}ms;lb={ms['lb']:.4f}ms;"
                 f"adapt_vs_static={gain:+.1f}%;seconds={secs:.3f}")
            out[(p, s)] = ms
            results[(p, s)] = res
    worst = out[(max(PERSISTENCE), max(SPREAD))]
    ok = worst["adapt"] < worst["cs"] and worst["adapt"] < worst["ss"]
    emit("fig8/adaptive_beats_static", 0.0,
         f"persistent_heterogeneous_cell={'PASS' if ok else 'FAIL'};"
         f"adapt={worst['adapt']:.4f}ms;cs={worst['cs']:.4f}ms;"
         f"ss={worst['ss']:.4f}ms")
    if not ok:
        raise SystemExit("fig8: adaptive schedule failed to beat static "
                         "CS/SS on the persistent heterogeneous cell")
    return out, results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=20000)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; no CPU fallback) or cpu")
    args = ap.parse_args()
    run(args.trials, args.device)


if __name__ == "__main__":
    main()
