"""Fig. 11 on the PyTorch port (beyond the paper): record -> replay ->
calibrate a cluster; counterpart of ``benchmarks/fig11_trace_replay.py``
(same cell, rows and guards), on the fig8/fig10 heterogeneous
persistent-straggler cell:

1. record: one ``sweep_rounds`` with ``record_trace=True`` captures the
   realized delay tables, written in the shared trace format and read back;
2. replay: the loaded trace through ``TraceProcess`` must reproduce the
   recording run's per-round times bit for bit (CS/SS, the
   censored-feedback adaptive scheme, LB);
3. calibrate: ``calibrate_trace`` fits a ``MarkovRegimeProcess``; the
   fitted cluster must keep the sign of the adaptive-vs-static margin.

Rows: ``fig11/<source>`` (model / trace / calib) with each source's
per-scheme ms/round and ``adapt_vs_static`` margin; ``fig11/replay`` the
max replay deviation (0); ``fig11/calibration`` the fit.  Exits non-zero
if replay diverges or the calibrated margin's sign flips.
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.core import (TraceProcess, adaptive_spec, calibrate_trace,
                              cyclic_to_matrix, ec2_cluster, lb_spec,
                              load_trace, save_trace, scenario1,
                              staircase_to_matrix, sweep_rounds, to_spec)

from .common import emit

N, R, K = 12, 3, 9
ROUNDS = 20
PERSISTENCE, SPREAD = 0.98, 3.0
CHUNK = 1000


def _process():
    return ec2_cluster(N, spread=SPREAD, p_slow=0.25,
                       persistence=PERSISTENCE, slow=8.0, base=scenario1(),
                       seed=1)


def _specs():
    return [to_spec("cs", cyclic_to_matrix(N, R)),
            to_spec("ss", staircase_to_matrix(N, R)),
            adaptive_spec("adapt", cyclic_to_matrix(N, R)),
            lb_spec(R)]


def _sweep(process, trials, seed, device, record=False):
    return sweep_rounds(_specs(), process, N, rounds=ROUNDS, k=K,
                        trials=trials, seed=seed, chunk=min(CHUNK, trials),
                        censored_feedback=True, record_trace=record,
                        devices=device)


def _margin(res) -> float:
    """Adaptive-vs-static margin (%) of the censored-feedback adaptive
    scheme over the better static schedule."""
    ms = {nm: res.mean_round(nm) for nm in ("cs", "ss", "adapt")}
    static = min(ms["cs"], ms["ss"])
    return 100.0 * (static - ms["adapt"]) / static


def _emit_source(src: str, res, common: str) -> float:
    ms = {nm: res.mean_round(nm) * 1e3 for nm in ("cs", "ss", "adapt",
                                                  "lb")}
    margin = _margin(res)
    emit(f"fig11/{src}", ms["adapt"] * 1e3,
         f"{common};cs={ms['cs']:.4f}ms;ss={ms['ss']:.4f}ms;"
         f"adapt={ms['adapt']:.4f}ms;lb={ms['lb']:.4f}ms;"
         f"adapt_vs_static={margin:+.1f}%")
    return margin


def run(trials: int = 20000, device=None, out: str = "bench_out_torch"):
    trials = min(trials, 3000)      # ROUNDS sims x 3 sources + recording
    common = (f"trials={trials};rounds={ROUNDS};n={N};r={R};k={K};"
              f"persistence={PERSISTENCE};spread={SPREAD:g}")

    # 1. record (scored by replaying the captured tables) + file round trip
    rec = _sweep(_process(), trials, 0, device, record=True)
    os.makedirs(out, exist_ok=True)
    path = save_trace(os.path.join(out, "fig11_trace"), rec.trace)
    trace = load_trace(path)
    assert trace == rec.trace, "on-disk trace round-trip changed content"

    # 2. replay the loaded trace: bit-exact or bust
    rep = _sweep(TraceProcess(trace), trials, 99, device)
    dev = max(float(np.abs(np.asarray(rep.per_round[nm])
                           - np.asarray(rec.per_round[nm])).max())
              for nm in ("cs", "ss", "adapt", "lb"))
    exact = all(np.array_equal(rep.per_round[nm], rec.per_round[nm])
                for nm in ("cs", "ss", "adapt", "lb"))
    emit("fig11/replay", dev,
         f"{common};status={'PASS' if exact else 'FAIL'};"
         f"replay_max_dev={dev:g};file={os.path.basename(path)};"
         f"trace_mb={trace.T1.nbytes * 2 / 1e6:.1f}MB")

    # 3. calibrate a synthetic twin from the trace
    cal = calibrate_trace(trace, device=device)
    emit("fig11/calibration", cal.mean_rel_err * 100.0,
         f"p_slow={cal.p_slow:.3f};persistence={cal.persistence:.3f};"
         f"slow={cal.slow:.2f}x;mean_err={cal.mean_rel_err * 100:.1f}%;"
         f"comm_err={cal.comm_mean_rel_err * 100:.1f}%;"
         f"worker_err={cal.worker_mean_rel_err * 100:.1f}%;"
         f"lag1_trace={cal.lag1_trace:+.2f};lag1_fit={cal.lag1_fit:+.2f}")

    # adaptive-vs-static margins across the three delay sources
    m_model = _emit_source("model", _sweep(_process(), trials, 1, device),
                           common)
    m_trace = _emit_source("trace", rep, common)
    m_calib = _emit_source("calib", _sweep(cal.process, trials, 1, device),
                           common)

    sign_ok = (m_calib > 0) == (m_trace > 0)
    ok = exact and sign_ok
    emit("fig11/trace_replay_calibrate", 0.0,
         f"status={'PASS' if ok else 'FAIL'};"
         f"margin_model={m_model:+.1f}%;margin_trace={m_trace:+.1f}%;"
         f"margin_calib={m_calib:+.1f}%")
    if not exact:
        raise SystemExit(
            f"fig11: trace replay diverged from the recording run "
            f"(max deviation {dev:g}) — the record/replay contract is "
            f"broken")
    if not sign_ok:
        raise SystemExit(
            f"fig11: the calibrated cluster flips the adaptive-vs-static "
            f"margin sign (trace {m_trace:+.1f}% vs calibrated "
            f"{m_calib:+.1f}%) — calibration no longer preserves the "
            f"decision-relevant delay structure")
    return {"model": m_model, "trace": m_trace, "calib": m_calib}
