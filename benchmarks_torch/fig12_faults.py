"""Fig. 12 on the PyTorch port (beyond the paper): fault injection and
graceful degradation; counterpart of ``benchmarks/fig12_faults.py`` (same
cell, rows and guards), on the fig8/fig11 heterogeneous persistent-straggler
cell:

1. degrade: under spot preemption with a round deadline (1.5x the clean
   static mean round) and ``close_partial``, the censored-feedback adaptive
   scheme must beat the better static schedule on time per realized
   result;
2. survive: every scenario of the zoo (preemption / partition / rack /
   msgloss / diurnal) closes every round with finite times and sane
   degradation metrics (realized-k histograms summing to one);
3. replay: a recorded fault-bearing trace (version 2, +inf cells), written
   and read back, replays the recording run's per-round times and
   degradation streams bit for bit.

Rows: ``fig12/clean`` (the fault-free baseline and the deadline),
``fig12/preemption`` (time per realized task and ``adapt_vs_static``),
``fig12/zoo_<scenario>``, ``fig12/replay`` and ``fig12/fault_tolerance``.
Exits non-zero if the adaptive margin goes negative, a scenario deadlocks
or yields non-finite metrics, or replay diverges.
"""
from __future__ import annotations

import math
import os

import numpy as np

from repro_torch.core import (FAULT_SCENARIOS, TraceProcess, adaptive_spec,
                              cyclic_to_matrix, ec2_cluster, lb_spec,
                              load_trace, make_scenario, save_trace,
                              scenario1, staircase_to_matrix, sweep_rounds,
                              to_spec)

from .common import emit

N, R, K = 12, 3, 9
ROUNDS = 20
PERSISTENCE, SPREAD = 0.98, 3.0
CHUNK = 1000
SCHEMES = ("cs", "ss", "adapt", "lb")
DEADLINE_SLACK = 1.5            # deadline = slack x clean static mean round


def _base():
    return ec2_cluster(N, spread=SPREAD, p_slow=0.25,
                       persistence=PERSISTENCE, slow=8.0, base=scenario1(),
                       seed=1)


def _specs():
    return [to_spec("cs", cyclic_to_matrix(N, R)),
            to_spec("ss", staircase_to_matrix(N, R)),
            adaptive_spec("adapt", cyclic_to_matrix(N, R)),
            lb_spec(R)]


def _sweep(process, trials, seed, device, *, deadline=None, policy="wait",
           record=False):
    return sweep_rounds(_specs(), process, N, rounds=ROUNDS, k=K,
                        trials=trials, seed=seed, chunk=min(CHUNK, trials),
                        censored_feedback=True, record_trace=record,
                        deadline=deadline, deadline_policy=policy,
                        devices=device)


def _cost_per_task(res, nm: str) -> float:
    """Mean wall-clock per realized result (ms/task): mean effective round
    over mean realized k."""
    realized = float(np.mean(res.realized_k(nm)))
    return res.mean_round(nm) * 1e3 / max(realized, 1e-9)


def _finite_ok(res) -> bool:
    for nm in SCHEMES:
        if not np.isfinite(np.asarray(res.per_round[nm])).all():
            return False
        for key in ("realized_k", "missed", "stale"):
            if not np.isfinite(res.degradation[nm][key]).all():
                return False
        hist = res.khist(nm)
        if not np.allclose(hist.sum(axis=1), 1.0, atol=1e-5):
            return False
    return True


def run(trials: int = 20000, device=None, out: str = "bench_out_torch"):
    trials = min(trials, 2000)      # 8 ROUNDS-length sweeps + recording
    common = (f"trials={trials};rounds={ROUNDS};n={N};r={R};k={K};"
              f"persistence={PERSISTENCE};spread={SPREAD:g}")

    # the fault-free baseline fixes the round deadline for every scenario
    clean = _sweep(_base(), trials, 0, device)
    static_clean = min(clean.mean_round("cs"), clean.mean_round("ss"))
    deadline = DEADLINE_SLACK * static_clean
    emit("fig12/clean", clean.mean_round("adapt") * 1e3,
         f"{common};cs={clean.mean_round('cs') * 1e3:.4f}ms;"
         f"ss={clean.mean_round('ss') * 1e3:.4f}ms;"
         f"adapt={clean.mean_round('adapt') * 1e3:.4f}ms;"
         f"deadline={deadline * 1e3:.4f}ms")

    # 1. graceful degradation under spot preemption
    pre = _sweep(make_scenario("preemption", _base(), N), trials, 0, device,
                 deadline=deadline, policy="close_partial")
    cost = {nm: _cost_per_task(pre, nm) for nm in ("cs", "ss", "adapt")}
    static = min(cost["cs"], cost["ss"])
    margin = 100.0 * (static - cost["adapt"]) / static
    realized = {nm: float(np.mean(pre.realized_k(nm)))
                for nm in ("cs", "ss", "adapt")}
    emit("fig12/preemption", cost["adapt"],
         f"{common};policy=close_partial;"
         f"cs={cost['cs']:.4f}ms/task;ss={cost['ss']:.4f}ms/task;"
         f"adapt={cost['adapt']:.4f}ms/task;"
         f"realized_cs={realized['cs']:.2f};"
         f"realized_ss={realized['ss']:.2f};"
         f"realized_adapt={realized['adapt']:.2f};"
         f"adapt_vs_static={margin:+.1f}%")

    # 2. the scenario zoo never deadlocks and never yields NaN
    zoo_ok = True
    for sc in FAULT_SCENARIOS:
        res = _sweep(make_scenario(sc, _base(), N), trials, 0, device,
                     deadline=deadline, policy="close_partial")
        ok = _finite_ok(res)
        zoo_ok = zoo_ok and ok
        emit(f"fig12/zoo_{sc}", res.mean_round("adapt") * 1e3,
             f"{common};status={'PASS' if ok else 'FAIL'};"
             f"realized_k={float(np.mean(res.realized_k('adapt'))):.2f};"
             f"missed={float(np.mean(res.missed_fraction('adapt'))):.3f};"
             f"stale={float(np.mean(res.stale_fraction('adapt'))):.3f}")

    # 3. fault-bearing trace record -> save -> load -> replay, bit-exact
    rec = _sweep(make_scenario("preemption", _base(), N), trials, 0, device,
                 deadline=deadline, policy="close_partial", record=True)
    os.makedirs(out, exist_ok=True)
    path = save_trace(os.path.join(out, "fig12_fault_trace"), rec.trace)
    trace = load_trace(path)
    assert trace == rec.trace, "on-disk fault-trace round-trip changed it"
    if not trace.has_faults:
        raise SystemExit("fig12: recorded preemption trace carries no "
                         "+inf cells — fault injection is not reaching "
                         "the recorder")
    rep = _sweep(TraceProcess(trace), trials, 99, device, deadline=deadline,
                 policy="close_partial")
    dev = max(float(np.abs(np.asarray(rep.per_round[nm])
                           - np.asarray(rec.per_round[nm])).max())
              for nm in SCHEMES)
    exact = all(np.array_equal(rep.per_round[nm], rec.per_round[nm])
                for nm in SCHEMES)
    degr_exact = all(
        np.array_equal(rep.degradation[nm][key], rec.degradation[nm][key])
        for nm in SCHEMES for key in ("realized_k", "missed", "stale",
                                      "khist"))
    emit("fig12/replay", dev,
         f"{common};status={'PASS' if exact and degr_exact else 'FAIL'};"
         f"replay_max_dev={dev:g};degradation_exact={degr_exact};"
         f"file={os.path.basename(path)};"
         f"trace_mb={trace.T1.nbytes * 2 / 1e6:.1f}MB")

    ok = (margin > 0) and zoo_ok and exact and degr_exact
    emit("fig12/fault_tolerance", 0.0,
         f"status={'PASS' if ok else 'FAIL'};"
         f"adapt_vs_static={margin:+.1f}%;zoo={'PASS' if zoo_ok else 'FAIL'};"
         f"replay={'PASS' if exact and degr_exact else 'FAIL'}")
    if not math.isfinite(margin):
        raise SystemExit("fig12: non-finite adaptive-vs-static margin — "
                         "the deadline path is leaking inf/NaN")
    if margin <= 0:
        raise SystemExit(
            f"fig12: adaptive + close_partial no longer beats the static "
            f"schedules under preemption ({margin:+.1f}% per realized "
            f"task) — crash-aware scheduling stopped paying")
    if not zoo_ok:
        raise SystemExit(
            "fig12: a fault scenario deadlocked or produced non-finite "
            "degradation metrics (see fig12/zoo_* rows)")
    if not (exact and degr_exact):
        raise SystemExit(
            f"fig12: fault-trace replay diverged from the recording run "
            f"(max deviation {dev:g}, degradation_exact={degr_exact}) — "
            f"the +inf record/replay contract is broken")
    return {"margin": margin, "deadline": deadline}
