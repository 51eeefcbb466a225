"""The port's fault-tolerance figures (Figs. 10-12) emit the reference's
rows and raise its guards.  Both modules' ``run`` are driven by one fake
engine (``sweep_rounds`` and ``calibrate_trace`` replaced by
deterministic stand-ins, with real traces written and read by each
package's own trace module), so the rows' names, derived keys and derived
text must be equal, and a guard that fires on one side fires on the other
with the same message.  No JAX program is compiled; the engine itself is
held against the reference in tests/test_torch_faults.py and
tests/test_torch_rebalance.py."""
import types

import numpy as np
import pytest

from benchmarks import common as jcommon
from benchmarks import (fig10_load_rebalance as j10, fig11_trace_replay as j11,
                        fig12_faults as j12)
from benchmarks_torch import common as tcommon
from benchmarks_torch import (fig10_load_rebalance as t10,
                              fig11_trace_replay as t11, fig12_faults as t12)
from repro.core import trace as jtrace
from repro_torch.core import trace as ttrace
from torch_parity import one_thread  # noqa: F401

#: ms per round of each scheme on a clean run
CLEAN = {"cs": 0.62, "ss": 0.61, "adapt": 0.57, "rebal": 0.55, "lb": 0.54}


class _FakeResult:
    def __init__(self, ms, rounds, k, degraded):
        self.per_round = {nm: np.full(rounds, v * 1e-3) for nm, v in
                          ms.items()}
        self.trace = None
        self.degradation = None
        if degraded:
            self.degradation = {nm: {
                "realized_k": np.full(rounds, k - 0.25),
                "missed": np.full(rounds, 0.125),
                "stale": np.full(rounds, 0.25 / k),
                "khist": np.tile(np.eye(k + 1)[k], (rounds, 1))}
                for nm in ms}

    def mean_round(self, nm):
        return float(self.per_round[nm].mean())

    def realized_k(self, nm):
        return self.degradation[nm]["realized_k"]

    def missed_fraction(self, nm):
        return self.degradation[nm]["missed"]

    def stale_fraction(self, nm):
        return self.degradation[nm]["stale"]

    def khist(self, nm):
        return self.degradation[nm]["khist"]


def _fake_engine(trace_mod, fault=None):
    """(sweep_rounds, calibrate_trace) stand-ins for one package.
    ``fault`` makes one guard fire: "rebal_slow" (fig10), "replay_differs",
    "calib_flips" (fig11), "adapt_loses", "zoo_nan", "no_faults"
    (fig12)."""
    def sweep_rounds(specs, process, n, *, rounds, k, seed=0,
                     record_trace=False, deadline=None, **kw):
        ms = {sp.name: CLEAN[sp.name] for sp in specs}
        calib = getattr(process, "calibrated", False)
        if fault == "rebal_slow" and "rebal" in ms:
            ms["rebal"] = 0.7
        if fault == "replay_differs" and seed == 99:
            ms["cs"] += 1e-3
        if fault == "calib_flips" and calib:
            ms["adapt"] = 0.9
        if fault == "adapt_loses" and deadline is not None:
            ms["adapt"] = 0.9
        if (fault == "zoo_nan" and deadline is not None
                and "Diurnal" in type(process).__name__):
            ms["adapt"] = float("nan")
        res = _FakeResult(ms, rounds, k, deadline is not None)
        if record_trace:
            T = np.full((rounds, 2, n, 3), 1e-4, np.float32)
            if fault != "no_faults" and deadline is not None:
                T[0, 0, 0] = np.inf
            res.trace = trace_mod.DelayTrace(T, T)
        return res

    def calibrate_trace(trace, **kw):
        return types.SimpleNamespace(
            process=types.SimpleNamespace(calibrated=True), p_slow=0.25,
            persistence=0.98, slow=8.0, mean_rel_err=0.01,
            comm_mean_rel_err=0.02, worker_mean_rel_err=0.03,
            lag1_trace=0.97, lag1_fit=0.96)

    return sweep_rounds, calibrate_trace


def _drive(mod, common, trace_mod, fault, tmp, **kw):
    sweep, calib = _fake_engine(trace_mod, fault)
    patch = {"sweep_rounds": sweep}
    if hasattr(mod, "calibrate_trace"):
        patch["calibrate_trace"] = calib
    saved = {k: getattr(mod, k) for k in patch}
    common.drain_rows()
    try:
        for k, v in patch.items():
            setattr(mod, k, v)
        if mod.__name__.endswith(("fig11_trace_replay", "fig12_faults")):
            kw["out"] = str(tmp)           # where the trace file goes
        try:
            mod.run(4000, **kw)
            err = None
        except SystemExit as e:
            err = str(e)
    finally:
        for k, v in saved.items():
            setattr(mod, k, v)
    rows = [(r["name"], r["derived_raw"]) for r in common.drain_rows()]
    return rows, err


CASES = [("fig10", None), ("fig10", "rebal_slow"),
         ("fig11", None), ("fig11", "replay_differs"),
         ("fig11", "calib_flips"),
         ("fig12", None), ("fig12", "adapt_loses"), ("fig12", "zoo_nan"),
         ("fig12", "no_faults")]
MODULES = {"fig10": (j10, t10), "fig11": (j11, t11), "fig12": (j12, t12)}


@pytest.mark.parametrize("fig,fault", CASES)
def test_rows_and_guards_equal_the_references(fig, fault, tmp_path):
    jmod, tmod = MODULES[fig]
    want, want_err = _drive(jmod, jcommon, jtrace, fault, tmp_path / "j")
    got, got_err = _drive(tmod, tcommon, ttrace, fault, tmp_path / "t",
                          device="cpu")
    assert got == want
    assert got_err == want_err
    assert (want_err is None) == (fault is None)


def test_cells_equal_the_references():
    """The grids: the cluster, the schemes and their loads, rounds, trial
    caps (read from the reference modules)."""
    for j, t in MODULES.values():
        for name in ("N", "R", "K", "ROUNDS", "PERSISTENCE", "SPREAD"):
            assert getattr(t, name) == getattr(j, name), name
    assert t10.CAP == j10.CAP
    assert t12.SCHEMES == j12.SCHEMES
    assert t12.DEADLINE_SLACK == j12.DEADLINE_SLACK
    assert (t11.CHUNK, t12.CHUNK) == (j11.CHUNK, j12.CHUNK)
    jp, tp = j10._process(), t10._process()
    assert (tp.worker_scale, tp.p_slow, tp.persistence, tp.slow) == (
        jp.worker_scale, jp.p_slow, jp.persistence, jp.slow)
