"""The port's Fig. 13 (``benchmarks_torch/fig13_live.py``) emits the
reference's rows and raises its guards.  Both modules' ``run`` are driven
by one fake live layer and engine (``run_live`` and ``sweep_rounds``
replaced by deterministic stand-ins, with real traces of each package's
own trace module), so the rows' names, derived keys and derived text must
be equal, and a guard that fires on one side fires on the other with the
same message.  No JAX program is compiled; the live layer itself is held
against the reference in tests/test_torch_live.py, and the port's Fig. 13
runs for real in tests/test_torch_benchmarks.py."""
import types

import numpy as np
import pytest

from benchmarks import common as jcommon
from benchmarks import fig13_live as j13
from benchmarks_torch import common as tcommon
from benchmarks_torch import fig13_live as t13
from repro.core import trace as jtrace
from repro_torch.core import trace as ttrace

#: the fake cluster's per-round completion times
PER_ROUND = np.linspace(5e-4, 9.75e-4, j13.ROUNDS)


def _fake(trace_mod, fault):
    """(run_live, sweep_rounds) stand-ins for one package.  ``fault``
    makes one guard fire: "replay_differs", "inaccurate",
    "deadline_differs"."""
    T = np.full((j13.ROUNDS, 1, j13.N, j13.R), 1e-4, np.float32)

    def run_live(cfg, process, rounds, **kw):
        per = PER_ROUND.copy()
        realized = np.full(rounds, cfg.k)
        missed = np.zeros(rounds, bool)
        if cfg.deadline is not None:
            missed = per > cfg.deadline
            per = np.minimum(per, np.float32(cfg.deadline))
            realized = np.where(missed, cfg.k - 1, cfg.k)
        return types.SimpleNamespace(
            per_round=per, realized=realized, missed=missed,
            mean=float(per.mean()), trace=trace_mod.DelayTrace(T, T))

    def sweep_rounds(specs, process, n, *, rounds, k, trials, seed=0,
                     deadline=None, deadline_policy="wait",
                     record_trace=False, **kw):
        per = PER_ROUND.copy()
        if trials > 1 and fault == "inaccurate":
            per = 3 * per
        if type(process).__name__ == "TraceProcess" and (
                fault == "replay_differs"):
            per = per + 1e-6
        res = types.SimpleNamespace(per_round={specs[0].name: per},
                                    degradation=None)
        res.mean_round = lambda nm: float(res.per_round[nm].mean())
        if deadline is not None:
            missed = per > deadline
            realized = np.where(missed, k - 1, k).astype(np.float64)
            if fault == "deadline_differs":
                realized[0] -= 1
            res.per_round = {specs[0].name: np.minimum(
                per, np.float32(deadline))}
            res.degradation = {specs[0].name: {
                "realized_k": realized, "missed": missed.astype(np.float64)}}
        return res

    return run_live, sweep_rounds


def _drive(mod, common, trace_mod, fault, **kw):
    run_live, sweep_rounds = _fake(trace_mod, fault)
    saved = {"run_live": mod.run_live, "sweep_rounds": mod.sweep_rounds}
    common.drain_rows()
    try:
        mod.run_live, mod.sweep_rounds = run_live, sweep_rounds
        try:
            mod.run(4000, **kw)
            err = None
        except SystemExit as e:
            err = str(e)
    finally:
        for k, v in saved.items():
            setattr(mod, k, v)
    return [(r["name"], r["derived_raw"]) for r in common.drain_rows()], err


@pytest.mark.parametrize("fault", [None, "replay_differs", "inaccurate",
                                   "deadline_differs"])
def test_rows_and_guards_equal_the_references(fault):
    want, want_err = _drive(j13, jcommon, jtrace, fault)
    got, got_err = _drive(t13, tcommon, ttrace, fault, device="cpu")
    assert got == want
    assert got_err == want_err
    assert (want_err is None) == (fault is None)
    assert [nm for nm, _ in got] == ["fig13/exact", "fig13/accuracy",
                                     "fig13/deadline"]


def test_cell_equals_the_references():
    for name in ("N", "R", "K", "ROUNDS", "PERSISTENCE", "SPREAD", "SEED",
                 "Z", "REL_FLOOR"):
        assert getattr(t13, name) == getattr(j13, name), name
    jp, tp = j13._process(), t13._process()
    assert (tp.worker_scale, tp.p_slow, tp.persistence, tp.slow) == (
        jp.worker_scale, jp.p_slow, jp.persistence, jp.slow)
