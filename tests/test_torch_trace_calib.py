"""Trace calibration (``calibrate_trace``) — the port against the JAX
package on shared traces.

The fit is float64 numpy arithmetic on the host in both packages, so the
fitted parameters (scales, regime share, persistence, slow factor, the
truncated-Gaussian base) and the trace's own lag-1 autocorrelation agree
to rel 1e-12.  The fit-quality fields are Monte-Carlo estimates from the
fitted process, and the two packages draw different random numbers: each
field of the port's report is within 4.5 combined standard errors of the
JAX package's, the standard errors estimated from the port's own sample of
the fitted process (per-(trial, worker) chain means for the moments, eight
trial batches for the lag-1 autocorrelation).
"""
import numpy as np
import pytest

from repro.core import trace as jt
from repro_torch.core import trace as tt
from torch_parity import one_thread  # noqa: F401

N, R, ROUNDS, TRIALS = 6, 3, 16, 24
FIT_TRIALS = 2048


def _trace(kind: str):
    """(T1, T2) float32 tables made with numpy: per-worker speed scales
    (spread 3) times, for "regime" and "faults", a persistent slow regime
    (a two-state chain per (trial, worker), stationary share 0.25,
    persistence 0.95, slow x8); "faults" also kills a tenth of the
    (round, trial, worker) cells (+inf compute) and drops a twentieth of
    the messages (+inf communication)."""
    gen = np.random.default_rng(sum(map(ord, kind)))
    scale = np.exp(gen.permutation(np.linspace(-0.5, 0.5, N)) * np.log(3))
    slow = np.zeros((ROUNDS, TRIALS, N), bool)
    if kind != "hetero":
        p, rho = 0.25, 0.95
        s = gen.random((TRIALS, N)) < p
        for t in range(ROUNDS):
            u = gen.random((TRIALS, N))
            s = np.where(s, u >= (1 - rho) * (1 - p), u < (1 - rho) * p)
            slow[t] = s
    f = (np.where(slow, 8.0, 1.0) * scale)[..., None]
    T1 = 1e-4 * (0.7 + 0.6 * gen.random((ROUNDS, TRIALS, N, R))) * f
    T2 = 5e-4 * (0.6 + 0.8 * gen.random((ROUNDS, TRIALS, N, R))) * f
    if kind == "faults":
        T1[gen.random((ROUNDS, TRIALS, N)) < 0.1] = np.inf
        T2[gen.random(T2.shape) < 0.05] = np.inf
    return T1.astype(np.float32), T2.astype(np.float32)


@pytest.fixture(scope="module")
def fits():
    out = {}
    for kind in ("regime", "hetero", "faults"):
        T1, T2 = _trace(kind)
        out[kind] = (
            jt.calibrate_trace(jt.DelayTrace(T1, T2), fit_trials=FIT_TRIALS),
            tt.calibrate_trace(tt.DelayTrace(T1, T2), fit_trials=FIT_TRIALS,
                               device="cpu"))
    return out


@pytest.mark.parametrize("kind", ["regime", "hetero", "faults"])
def test_fitted_parameters_equal(fits, kind):
    a, b = fits[kind]
    for f in ("p_slow", "persistence", "slow", "lag1_trace"):
        np.testing.assert_allclose(getattr(b, f), getattr(a, f), rtol=1e-12,
                                   atol=0)
    np.testing.assert_allclose(b.worker_scale, a.worker_scale, rtol=1e-12)
    for f in ("mu1", "sigma1", "a1", "mu2", "sigma2", "a2"):
        np.testing.assert_allclose(getattr(b.process.base, f),
                                   getattr(a.process.base, f), rtol=1e-12)
    pa, pb = a.process, b.process
    assert (pb.p_slow, pb.persistence, pb.slow) == (pa.p_slow,
                                                    pa.persistence, pa.slow)
    assert type(pb).__name__ == "MarkovRegimeProcess"


def test_the_regimes_are_found(fits):
    assert fits["regime"][1].p_slow > 0.1
    assert fits["regime"][1].persistence > 0.5
    assert fits["hetero"][1].p_slow == 0.0


def _mc_bounds(rep, T1, T2):
    """4.5 combined standard errors (two independent estimates of one
    size) of each fit-quality field, from the port's own sample of the
    fitted process."""
    F1, F2 = rep.process.sample_rounds(0, FIT_TRIALS, N, R, ROUNDS,
                                       device="cpu")
    F1, F2 = F1.numpy().astype(np.float64), F2.numpy().astype(np.float64)
    z = 4.5 * np.sqrt(2.0)

    def se_mean(F, T):                 # chains: (trial, worker) means
        m = F.mean(axis=(0, 3))
        return m.std() / np.sqrt(m.size) / np.nanmean(np.where(
            np.isfinite(T), T, np.nan))

    worker = max(F1[:, :, i].mean(axis=(0, 2)).std() / np.sqrt(FIT_TRIALS)
                 / np.nanmean(np.where(np.isfinite(T1[:, :, i]),
                                       T1[:, :, i], np.nan))
                 for i in range(N))
    batches = [tt._lag1(F1[:, b::8].mean(axis=3)) for b in range(8)]
    return {"mean_rel_err": z * se_mean(F1, T1),
            "comm_mean_rel_err": z * se_mean(F2, T2),
            "worker_mean_rel_err": z * worker,
            "lag1_fit": z * np.std(batches) / np.sqrt(8)}


@pytest.mark.parametrize("kind", ["regime", "hetero", "faults"])
def test_fit_quality_agrees(fits, kind):
    a, b = fits[kind]
    T1, T2 = _trace(kind)
    for field, bound in _mc_bounds(b, T1, T2).items():
        assert abs(getattr(b, field) - getattr(a, field)) < bound, field
    assert "calibrated MarkovRegimeProcess" in b.summary()


def test_otsu_and_lag1_equal():
    gen = np.random.default_rng(4)
    x = np.concatenate([gen.normal(0, 1, 500), gen.normal(3, 0.5, 200)])
    assert tt._otsu_threshold(x) == jt._otsu_threshold(x)
    m = gen.random((9, 4, 5))
    m[2, 1, 3] = np.nan
    assert tt._lag1(m) == jt._lag1(m)
    assert tt._lag1(m[:1]) == jt._lag1(m[:1]) == 0.0


def test_calibration_refuses_an_all_fault_trace_alike():
    T = np.full((3, 2, N, R), np.inf, np.float32)
    ones = np.ones_like(T)
    with pytest.raises(ValueError, match="fault-censored"):
        jt.calibrate_trace(jt.DelayTrace(T, ones))
    with pytest.raises(ValueError, match="fault-censored"):
        tt.calibrate_trace(tt.DelayTrace(T, ones), device="cpu")
