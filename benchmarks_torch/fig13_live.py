"""Fig. 13 on the PyTorch port (beyond the paper): the live execution layer
vs the simulator; counterpart of ``benchmarks/fig13_live.py`` (same cell,
rows and guards).

The live layer (``repro_torch.live``) really runs the master-worker
protocol — async workers streaming messages, a master closing rounds at
``k`` distinct results — so this benchmark pins the contract that makes it
*the same experiment* as the Monte Carlo engine:

  1. **exact** — a live in-process run (``run_live``, ``time_scale=0``,
     ``abort_on_close=False``) must reproduce
     ``sweep_rounds(process, trials=1, seed, record_trace=True)``
     per-round completion times BIT-EXACTLY (workers run the engine's own
     recording pass for the delay tables, on the same device), and the
     live trace must replay bit-exactly through ``TraceProcess``;
  2. **accuracy** — the live run's mean completion must sit within the
     Monte Carlo prediction's sampling tolerance: the live run is one
     realization of the process the engine averages over ``trials``
     realizations, so ``|live - MC| <= z * sd_live / sqrt(rounds_eff)``
     (persistence shrinks the effective sample count) with a relative
     floor;
  3. **deadline** — the same live cluster under a ``close_partial``
     deadline must match the engine's graceful-degradation streams
     (per-round realized-k and deadline misses) exactly, realization for
     realization.

Rows: ``fig13/exact`` (max deviation, must be 0), ``fig13/accuracy``
(live vs MC means, ``rel_err``), ``fig13/deadline``.  Exits non-zero on
any violation.  Runs on the card unless ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import (RoundConfig, TraceProcess, ec2_cluster,
                              scenario1, sweep_rounds)
from repro_torch.live import run_live

from .common import emit

N, R, K = 8, 2, 6
ROUNDS = 20
PERSISTENCE, SPREAD = 0.9, 3.0
SEED = 7
Z = 5.0                 # accuracy-leg tolerance: z * stderr of the live mean
REL_FLOOR = 0.10        # ... but never tighter than 10% relative


def _process():
    return ec2_cluster(N, spread=SPREAD, p_slow=0.25,
                       persistence=PERSISTENCE, slow=8.0, base=scenario1(),
                       seed=1)


def run(trials: int = 20000, device=None) -> dict:
    """The three legs; returns ``{"exact", "accurate", "deadline"}`` (the
    status of each) beside the rows.  Raises ``SystemExit`` on a
    violation."""
    trials = min(trials, 2000)
    cfg = RoundConfig(n=N, k=K, kind="cs", r=R, seed=SEED)
    spec = cfg.to_scheme_spec("cs")
    common = (f"n={N};r={R};k={K};rounds={ROUNDS};"
              f"persistence={PERSISTENCE};spread={SPREAD:g}")

    # ---- 1. exactness: live == engine (trials=1) == trace replay --------
    res = run_live(cfg, _process(), ROUNDS, abort_on_close=False,
                   device=device)
    live32 = res.per_round.astype(np.float32)
    one = sweep_rounds([spec], _process(), N, rounds=ROUNDS, trials=1,
                       k=K, seed=SEED, record_trace=True, devices=device)
    rep = sweep_rounds([spec], TraceProcess(res.trace), N, rounds=ROUNDS,
                       trials=1, k=K, seed=SEED, devices=device)
    dev_mc = float(np.abs(live32 - one.per_round["cs"].astype(
        np.float32)).max())
    dev_rp = float(np.abs(live32 - rep.per_round["cs"].astype(
        np.float32)).max())
    exact = dev_mc == 0.0 and dev_rp == 0.0
    emit("fig13/exact", max(dev_mc, dev_rp),
         f"{common};status={'PASS' if exact else 'FAIL'};"
         f"dev_vs_engine={dev_mc:g};dev_vs_replay={dev_rp:g};"
         f"trace={res.trace.header()['digest'][:8]}")

    # ---- 2. accuracy: live mean within MC sampling tolerance ------------
    pred = sweep_rounds([spec], _process(), N, rounds=ROUNDS,
                        trials=trials, k=K, seed=1, chunk=min(trials, 500),
                        devices=device)
    mc_mean = float(pred.mean_round("cs"))
    live_mean = res.mean
    # the live run is ONE trajectory: its mean over ROUNDS rounds has
    # stderr sd/sqrt(rounds_eff); persistent regimes correlate consecutive
    # rounds, shrinking the effective count by ~(1+p)/(1-p)
    rounds_eff = ROUNDS * (1 - PERSISTENCE) / (1 + PERSISTENCE)
    sd = float(res.per_round.std(ddof=1))
    tol = max(Z * sd / np.sqrt(max(rounds_eff, 1.0)), REL_FLOOR * mc_mean)
    rel_err = abs(live_mean - mc_mean) / mc_mean
    accurate = abs(live_mean - mc_mean) <= tol
    emit("fig13/accuracy", live_mean * 1e3,
         f"{common};trials={trials};status="
         f"{'PASS' if accurate else 'FAIL'};"
         f"live_mean={live_mean * 1e3:.4f}ms;mc_mean={mc_mean * 1e3:.4f}ms;"
         f"rel_err={rel_err:.4f};tol={tol / mc_mean:.4f}")

    # ---- 3. deadline: degradation accounting matches the engine ---------
    dl = float(np.quantile(res.per_round, 0.5))
    cfg_dl = RoundConfig(n=N, k=K, kind="cs", r=R, seed=SEED, deadline=dl,
                         deadline_policy="close_partial")
    res_dl = run_live(cfg_dl, _process(), ROUNDS, abort_on_close=False,
                      device=device)
    eng_dl = sweep_rounds([spec], _process(), N, rounds=ROUNDS, trials=1,
                          k=K, seed=SEED, deadline=dl,
                          deadline_policy="close_partial",
                          record_trace=True, devices=device)
    deg = eng_dl.degradation["cs"]
    t_ok = np.array_equal(res_dl.per_round.astype(np.float32),
                          eng_dl.per_round["cs"].astype(np.float32))
    k_ok = np.array_equal(res_dl.realized.astype(np.float64),
                          np.asarray(deg["realized_k"], np.float64))
    m_ok = np.array_equal(res_dl.missed.astype(np.float64),
                          np.asarray(deg["missed"], np.float64))
    dl_ok = t_ok and k_ok and m_ok
    emit("fig13/deadline", float(res_dl.missed.sum()),
         f"{common};deadline={dl:g};status={'PASS' if dl_ok else 'FAIL'};"
         f"times_exact={t_ok};realized_exact={k_ok};missed_exact={m_ok};"
         f"missed={int(res_dl.missed.sum())}/{ROUNDS};"
         f"mean_realized_k={res_dl.realized.mean():.2f}")

    if not exact:
        raise SystemExit(
            f"fig13: live run diverged from the engine (dev_vs_engine="
            f"{dev_mc:g}, dev_vs_replay={dev_rp:g}) — the live/simulator "
            f"contract is broken")
    if not accurate:
        raise SystemExit(
            f"fig13: live mean {live_mean:g} is outside the MC prediction "
            f"tolerance ({mc_mean:g} +- {tol:g})")
    if not dl_ok:
        raise SystemExit(
            "fig13: live deadline accounting diverged from the engine's "
            "degradation streams")
    return {"exact": exact, "accurate": accurate, "deadline": dl_ok}


if __name__ == "__main__":
    run()
