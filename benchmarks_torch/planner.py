"""Racing planner against the exhaustive grid on the port: the same argmin
for a fraction of the trial-evaluations; counterpart of
``benchmarks/planner.py`` (same rows and guards).

The 64-cell operating-point grid of ``grid_stream`` (n = 16, all six
families, loads x budgets x overheads) both ways, on ``device`` (the card
by default):

* exhaustively through ``stream_grid`` (every cell at the full trial
  count), the winner from ``GridResult.best_cell``;
* through the racing planner (``repro_torch.core.planner.plan``):
  closed-form dominance pruning, then successive halving with paired
  elimination on the resumable sweep.

Rows:
  planner/exhaustive  the streamed grid: cells, trial-evaluations, the
                      ``best_cell`` winner
  planner/race        the planner: winner, trials spent, pruned / raced
                      counts, ``saved`` = exhaustive / spent
                      trial-evaluations
  planner/agreement   ``agree=1`` iff both name the same winner and their
                      winning means agree within sampling resolution

Exits non-zero if the planner's argmin differs from the grid's, or if the
winner's raced mean drifts from the streamed cell's beyond sampling noise
(both read the same draws; the planner averages per-trial float64 samples
while the grid combines float32 chunk partials, so they agree to stderr
resolution, not bitwise).
"""
from __future__ import annotations

import math
import time

from repro_torch.core import plan, scenario1, stream_grid

from .common import emit
from .grid_stream import _grid

K = 16   # computation target for the winner report (= n: full gradient)


def run(trials: int = 20000, device=None, out: str = "bench_out_torch"):
    model = scenario1()
    gs = _grid(trials)

    # ---- exhaustive reference: every cell at the full trial count ----
    cells = gs.cells(model)
    t0 = time.perf_counter()
    res = stream_grid(cells, devices=device, pipeline=2)
    t_ex = time.perf_counter() - t0
    best = res.best_cell(k=K)
    emit("planner/exhaustive", t_ex * 1e6,
         f"cells={len(cells)};trials={trials};"
         f"trial_evals={len(cells) * trials};best={best['cell']};"
         f"best_mean={best['mean']:.6g};ties={len(best['ties'])}")

    # ---- racing planner on the same grid ----
    t0 = time.perf_counter()
    pr = plan(gs, model, k=K, devices=device)
    t_plan = time.perf_counter() - t0
    emit("planner/race", t_plan * 1e6,
         f"winner={pr.winner};trials_spent={pr.trials_spent};"
         f"exhaustive_trials={pr.exhaustive_trials};"
         f"saved={pr.savings:.2f};"
         f"pruned={pr.meta['theory_pruned']};"
         f"raced={pr.meta['raced_points']};"
         f"rungs={len(pr.trajectory)};"
         f"lb_gap={pr.lb_gap:.4f}")

    # ---- agreement: same argmin, consistent winning mean ----
    agree = pr.winner == best["cell"]
    se = math.hypot(pr.predicted_stderr, best["stderr"])
    mean_ok = abs(pr.predicted_mean - best["mean"]) <= 5 * max(se, 1e-300)
    emit("planner/agreement", 0.0,
         f"agree={1 if agree and mean_ok else 0};"
         f"planner={pr.winner};exhaustive={best['cell']};"
         f"mean_gap={abs(pr.predicted_mean - best['mean']):.3g}")
    if not agree:
        raise SystemExit(
            f"planner: argmin disagreement — racing picked {pr.winner!r} "
            f"but the exhaustive grid's best_cell is {best['cell']!r} "
            f"(exhaustive ties: {[t['cell'] for t in best['ties']]})")
    if not mean_ok:
        raise SystemExit(
            f"planner: winning-mean drift — planner {pr.predicted_mean} vs "
            f"exhaustive {best['mean']} exceeds 5 x combined stderr {se}")

    return {"winner": pr.winner, "saved": pr.savings,
            "trials_spent": pr.trials_spent,
            "exhaustive_trials": pr.exhaustive_trials,
            "exhaustive_seconds": t_ex, "plan_seconds": t_plan,
            "best": best["cell"], "agree": agree and mean_ok,
            "pruned": pr.meta["theory_pruned"],
            "raced": pr.meta["raced_points"], "rungs": len(pr.trajectory)}


if __name__ == "__main__":
    run()
