"""Trace-driven delay sources: a recorded cluster replayed through the
process API; counterpart of the ``DelayTrace`` / file format /
``TraceProcess`` part of ``repro.core.trace``.

``DelayTrace``
    An immutable per-(round, trial, worker, slot) table of realized
    computation (``T1``) and communication (``T2``) delays, identified by a
    SHA-1 digest over ``int64(shape) || T1 || T2``.

``save_trace`` / ``load_trace`` / ``validate_trace_file``
    The versioned on-disk format, byte-compatible with the JAX package's:
    an ``.npz`` with a JSON ``header`` member (format, version, shape,
    digest, meta) and the float32 ``T1``/``T2`` tables.  Fault-free traces
    are version 1, traces with +inf cells version 2.  Each package reads
    the other's files.

``TraceProcess``
    Replays a trace: trial ``t`` reads trial ``t % trace.trials`` of the
    table, so replay is invariant to chunking and to the device.  Axis
    policies (``pad_rounds`` / ``pad_workers`` / ``pad_slots``) and
    ``start_round`` are the JAX package's.

``calibrate_trace``
    Fits a ``MarkovRegimeProcess`` (per-worker speed scales, a slow/fast
    regime chain, a truncated-Gaussian base) to a trace and reports how
    well the fitted process reproduces it (``CalibrationReport``).  The fit
    is the JAX package's float64 numpy arithmetic on the host; only the
    final fit-quality Monte Carlo samples the fitted process, through the
    port's own sampler on the chosen device.

Traces come from files, from tables, or from a rounds sweep run with
``record_trace=True`` (``montecarlo.sweep_rounds`` /
``trajectory_samples``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .cluster import DelayProcess, MarkovRegimeProcess
from .delays import TruncatedGaussianDelays

__all__ = ["TRACE_FORMAT_VERSION", "DelayTrace", "TraceProcess",
           "save_trace", "load_trace", "validate_trace_file",
           "CalibrationReport", "calibrate_trace"]

TRACE_FORMAT_VERSION = 2       # v2: +inf delay cells (fault censoring)

_PAD_ROUNDS = ("error", "cycle", "hold")
_PAD_AXES = ("error", "cycle")


class DelayTrace:
    """Realized per-(round, trial, worker, slot) compute/comm delay tables.

    ``T1``/``T2`` are float32 numpy arrays of shape ``(rounds, trials, n,
    r)``; a 3-D ``(rounds, n, r)`` input gets a singleton trial axis.
    Instances are immutable, hashable and compared by content digest."""

    __slots__ = ("T1", "T2", "meta", "_digest")

    def __init__(self, T1, T2, meta: Optional[dict] = None):
        T1 = np.array(T1, np.float32)
        T2 = np.array(T2, np.float32)
        if T1.ndim == 3:
            T1, T2 = T1[:, None], (T2[:, None] if T2.ndim == 3 else T2)
        if T1.ndim != 4:
            raise ValueError(
                f"trace tables must be (rounds, n, r) or (rounds, trials, "
                f"n, r); got shape {T1.shape}")
        if T2.shape != T1.shape:
            raise ValueError(f"T1/T2 shape mismatch: {T1.shape} vs "
                             f"{T2.shape}")
        if 0 in T1.shape:
            raise ValueError(f"empty trace: shape {T1.shape}")
        # +inf is a legal cell (a result that never arrives); NaN and
        # non-positive delays are corrupt.
        if np.isnan(T1).any() or np.isnan(T2).any():
            raise ValueError("trace delays must not be NaN")
        if (T1 <= 0).any() or (T2 <= 0).any():
            raise ValueError("trace delays must be positive")
        T1.setflags(write=False)
        T2.setflags(write=False)
        object.__setattr__(self, "T1", T1)
        object.__setattr__(self, "T2", T2)
        object.__setattr__(self, "meta", dict(meta or {}))
        h = hashlib.sha1()
        h.update(np.int64(T1.shape).tobytes())
        h.update(T1.tobytes())
        h.update(T2.tobytes())
        object.__setattr__(self, "_digest", h.hexdigest())

    def __setattr__(self, *a):
        raise AttributeError("DelayTrace is immutable")

    def __hash__(self):
        return hash(self._digest)

    def __eq__(self, other):
        return (isinstance(other, DelayTrace)
                and self._digest == other._digest)

    def __repr__(self):
        return (f"DelayTrace(rounds={self.rounds}, trials={self.trials}, "
                f"n={self.n}, r={self.r}, digest={self._digest[:8]})")

    @property
    def rounds(self) -> int:
        return self.T1.shape[0]

    @property
    def trials(self) -> int:
        return self.T1.shape[1]

    @property
    def n(self) -> int:
        return self.T1.shape[2]

    @property
    def r(self) -> int:
        return self.T1.shape[3]

    @property
    def has_faults(self) -> bool:
        """True when any cell is +inf (a result that never arrives)."""
        return bool(np.isinf(self.T1).any() or np.isinf(self.T2).any())

    def header(self) -> dict:
        """The JSON header ``save_trace`` writes: version 1 for fault-free
        traces, 2 (with ``"faults": true``) when a cell is +inf."""
        faulty = self.has_faults
        hdr = {"format": "repro.delay_trace",
               "version": 2 if faulty else 1,
               "rounds": self.rounds, "trials": self.trials,
               "n": self.n, "r": self.r, "dtype": "float32",
               "digest": self._digest, "meta": self.meta}
        if faulty:
            hdr["faults"] = True
        return hdr


def save_trace(path: str, trace: DelayTrace) -> str:
    """Write ``trace`` to ``path`` (``.npz`` appended if missing) in the
    versioned npz + JSON-header format.  Returns the path written."""
    if not str(path).endswith(".npz"):
        path = f"{path}.npz"
    hdr = trace.header()
    hdr["created_unix"] = time.time()
    np.savez_compressed(path,
                        header=np.frombuffer(
                            json.dumps(hdr).encode(), dtype=np.uint8),
                        T1=trace.T1, T2=trace.T2)
    return path


def _read_header(z) -> dict:
    if "header" not in z:
        raise ValueError("not a delay-trace file: missing 'header' member")
    try:
        hdr = json.loads(bytes(z["header"].tobytes()).decode())
    except Exception as e:
        raise ValueError(f"corrupt delay-trace header: {e}") from e
    if hdr.get("format") != "repro.delay_trace":
        raise ValueError(f"not a delay-trace file: format="
                         f"{hdr.get('format')!r}")
    if int(hdr.get("version", -1)) > TRACE_FORMAT_VERSION:
        raise ValueError(
            f"delay-trace version {hdr.get('version')} is newer than this "
            f"reader (supports <= {TRACE_FORMAT_VERSION})")
    return hdr


def load_trace(path: str) -> DelayTrace:
    """Read a trace written by ``save_trace`` (by either package),
    validating version, shapes and the content digest."""
    with np.load(path) as z:
        hdr = _read_header(z)
        if "T1" not in z or "T2" not in z:
            raise ValueError(f"{path}: missing T1/T2 tables")
        trace = DelayTrace(z["T1"], z["T2"], meta=hdr.get("meta"))
    want = (hdr["rounds"], hdr["trials"], hdr["n"], hdr["r"])
    if trace.T1.shape != want:
        raise ValueError(f"{path}: header says shape {want}, tables are "
                         f"{trace.T1.shape}")
    if hdr.get("digest") and hdr["digest"] != trace._digest:
        raise ValueError(f"{path}: content digest mismatch (corrupt or "
                         f"hand-edited tables)")
    return trace


def validate_trace_file(path: str) -> dict:
    """Validate a trace file; returns its header dict (raises
    ``ValueError`` on any format problem)."""
    return load_trace(path).header()


@dataclasses.dataclass(frozen=True)
class TraceProcess(DelayProcess):
    """Replay a recorded ``DelayTrace`` through the ``init``/``step`` API.

    Deterministic: seeds are ignored, trial ``t`` reads trial ``t %
    trace.trials``.  Axis policies when a run asks for more than was
    recorded: ``pad_rounds`` ``"error"`` (raised by ``check_rounds``, which
    every engine calls), ``"cycle"`` or ``"hold"`` (repeat the final
    round); ``pad_workers`` / ``pad_slots`` ``"error"`` or ``"cycle"``.
    Smaller requests use the leading workers/slots/rounds.  ``start_round``
    begins replay that many rounds into the recording."""
    trace: DelayTrace = None
    pad_rounds: str = "error"
    pad_workers: str = "error"
    pad_slots: str = "error"
    start_round: int = 0

    def __post_init__(self):
        if not isinstance(self.trace, DelayTrace):
            raise TypeError(f"TraceProcess needs a DelayTrace, got "
                            f"{type(self.trace).__name__}")
        if self.pad_rounds not in _PAD_ROUNDS:
            raise ValueError(f"pad_rounds must be one of {_PAD_ROUNDS}, "
                             f"got {self.pad_rounds!r}")
        for name in ("pad_workers", "pad_slots"):
            if getattr(self, name) not in _PAD_AXES:
                raise ValueError(f"{name} must be one of {_PAD_AXES}, got "
                                 f"{getattr(self, name)!r}")
        if not 0 <= int(self.start_round):
            raise ValueError(f"start_round must be >= 0, got "
                             f"{self.start_round}")

    def _axis_index(self, want: int, have: int, axis: str,
                    policy: str) -> Optional[np.ndarray]:
        """Wrap-around index for an over-long axis, or None when leading
        slices suffice."""
        if want <= have:
            return None
        if policy == "error":
            raise ValueError(
                f"replay needs {want} {axis} but the trace recorded only "
                f"{have}; pass pad_{axis}='cycle' to wrap the recording "
                f"(TraceProcess(trace, pad_{axis}='cycle'))")
        return np.arange(want) % have

    def check_rounds(self, rounds: int) -> None:
        need = rounds + int(self.start_round)
        if self.pad_rounds == "error" and need > self.trace.rounds:
            raise ValueError(
                f"replay needs {need} rounds (start_round="
                f"{self.start_round}) but the trace recorded only "
                f"{self.trace.rounds}; pass pad_rounds='cycle' (wrap) or "
                f"'hold' (repeat the final round) to extend it")

    def init(self, seed, tids, n):
        self._axis_index(n, self.trace.n, "workers", self.pad_workers)
        return (int(self.start_round),
                tids.to(torch.int64) % self.trace.trials)

    def step(self, state, seed, tids, n, r):
        t = self.trace
        ridx, rows = state
        widx = self._axis_index(n, t.n, "workers", self.pad_workers)
        sidx = self._axis_index(r, t.r, "slots", self.pad_slots)
        rnow = (min(ridx, t.rounds - 1) if self.pad_rounds == "hold"
                else ridx % t.rounds)

        def pick(table):
            x = torch.as_tensor(np.array(table[rnow]), device=rows.device)[rows]
            x = x[:, widx] if widx is not None else x[:, :n]
            x = x[:, :, sidx] if sidx is not None else x[:, :, :r]
            return x

        return (ridx + 1, rows), pick(t.T1), pick(t.T2)


# ------------------------------- calibration ---------------------------------

def _otsu_threshold(x: np.ndarray) -> float:
    """Between-class-variance-maximizing split point of a 1-D sample
    (Otsu's method on a 64-bin histogram): segments per-round worker means
    into fast / slow regimes without assuming a slow factor."""
    lo, hi = float(x.min()), float(x.max())
    edges = np.linspace(lo, hi, 65)
    hist, _ = np.histogram(x, bins=edges)
    centers = 0.5 * (edges[:-1] + edges[1:])
    w = hist / hist.sum()
    mu = centers * w
    w0 = np.cumsum(w)
    m0 = np.cumsum(mu)
    m_tot = m0[-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        between = (m_tot * w0 - m0) ** 2 / (w0 * (1.0 - w0))
    between[~np.isfinite(between)] = -np.inf
    return float(centers[int(np.argmax(between))])


@dataclasses.dataclass(frozen=True)
class CalibrationReport:
    """A parametric cluster fitted to a ``DelayTrace``, and how well it
    fits.  ``process`` is the assembled ``MarkovRegimeProcess``; the
    ``*_rel_err`` fields compare Monte-Carlo moments of the fitted process
    with the trace (overall compute and communication means, the worst
    per-worker compute mean), and ``lag1_trace`` / ``lag1_fit`` the lag-1
    autocorrelation of per-(round, worker) means."""
    process: MarkovRegimeProcess
    worker_scale: tuple
    p_slow: float
    persistence: float
    slow: float
    mean_rel_err: float
    comm_mean_rel_err: float
    worker_mean_rel_err: float
    lag1_trace: float
    lag1_fit: float

    def summary(self) -> str:
        return (f"calibrated MarkovRegimeProcess: p_slow={self.p_slow:.3f} "
                f"persistence={self.persistence:.3f} slow={self.slow:.2f}x "
                f"scale_spread="
                f"{max(self.worker_scale) / min(self.worker_scale):.2f}x | "
                f"fit: mean_err={self.mean_rel_err * 100:.1f}% "
                f"comm_err={self.comm_mean_rel_err * 100:.1f}% "
                f"worst_worker_err={self.worker_mean_rel_err * 100:.1f}% "
                f"lag1 {self.lag1_trace:+.2f}->{self.lag1_fit:+.2f}")


def _lag1(m: np.ndarray) -> float:
    """Lag-1 autocorrelation over the round axis of per-(round, trial,
    worker) means, pooled across trials and workers (fault-censored pairs
    dropped)."""
    if m.shape[0] < 2:
        return 0.0
    a, b = m[:-1].reshape(-1), m[1:].reshape(-1)
    ok = np.isfinite(a) & np.isfinite(b)
    if not ok.all():
        a, b = a[ok], b[ok]
    if a.size < 2 or a.std() == 0 or b.std() == 0:
        return 0.0
    return float(np.corrcoef(a, b)[0, 1])


def calibrate_trace(trace: DelayTrace, *, min_slow_factor: float = 1.5,
                    fit_trials: int = 512, seed: int = 0,
                    device=None) -> CalibrationReport:
    """Fit a heterogeneous persistent-straggler cluster to a trace (the JAX
    package's estimators, in float64 numpy).

    Segmentation runs on the log per-(round, trial, worker) mean compute
    delays with each worker's median removed; a slow regime is declared
    only when the fast/slow separation exceeds ``min_slow_factor``, else
    the fit is a pure heterogeneous-scale cluster (``p_slow = 0``).
    ``worker_scale``: per-worker fast-cell mean over the global fast mean,
    geometric mean 1; ``slow``: slow-to-fast mean ratio; ``p_slow``: the
    slow-cell share; ``persistence``: 1 - p(fast->slow) - p(slow->fast)
    from the regime transitions, clipped to [0, 1]; the base: a truncated
    Gaussian matched to the de-scaled fast cells' moments.  +inf cells
    (faults) are masked out of every estimator.

    The fit-quality report samples ``fit_trials`` trials of the fitted
    process over the trace's rounds with the port's sampler (seed
    ``seed``) on ``device`` (the card by default)."""
    T1 = np.asarray(trace.T1, np.float64)            # (R, t, n, r)
    T2 = np.asarray(trace.T2, np.float64)
    R, _, n, r = T1.shape
    fin1 = np.isfinite(T1)
    cnt = fin1.sum(axis=3)                           # (R, t, n)
    if not cnt.any():
        raise ValueError("cannot calibrate: every cell of the trace is "
                         "fault-censored (+inf)")
    m1 = np.where(cnt > 0,
                  np.where(fin1, T1, 0.0).sum(axis=3) / np.maximum(cnt, 1),
                  np.nan)                            # (R, t, n) round means
    valid = cnt > 0
    X = np.log(m1)
    Xc = X - np.nanmedian(X, axis=(0, 1), keepdims=True)  # de-heterogenize

    thr = _otsu_threshold(Xc[valid].reshape(-1))
    slow_mask = valid & (Xc > thr)
    fast = valid & ~slow_mask
    n_valid = int(valid.sum())
    frac = float(slow_mask.sum() / n_valid)
    sep = (np.exp(Xc[slow_mask].mean() - Xc[fast].mean())
           if 0.0 < frac < 1.0 else 1.0)

    if not 0.0 < frac < 1.0 or sep < min_slow_factor:
        # no credible slow regime: pure heterogeneous scales
        slow_mask = np.zeros_like(slow_mask)
        fast = valid
        p_slow, slow, persistence = 0.0, 1.0, 0.0
    else:
        p_slow = frac
        slow = float(sep)
        # regime transitions on valid consecutive cell pairs only
        pair = valid[:-1] & valid[1:]
        n_fast = int((~slow_mask[:-1] & pair).sum())
        n_slow = int((slow_mask[:-1] & pair).sum())
        p_fs = (float((~slow_mask[:-1] & slow_mask[1:] & pair).sum())
                / n_fast if n_fast else 0.0)
        p_sf = (float((slow_mask[:-1] & ~slow_mask[1:] & pair).sum())
                / n_slow if n_slow else 0.0)
        persistence = float(np.clip(1.0 - p_fs - p_sf, 0.0, 1.0))

    # per-worker scale on the fast regime (mean ratio), geometric mean 1
    glob = m1[fast].mean() if fast.any() else m1[valid].mean()

    def _wmean(i):
        if fast[..., i].any():
            return m1[..., i][fast[..., i]].mean()
        if valid[..., i].any():
            return m1[..., i][valid[..., i]].mean()
        return glob          # a worker that never delivered: neutral

    wm = np.array([_wmean(i) for i in range(n)])
    scale = wm / np.exp(np.log(wm).mean())
    scale = tuple(float(v) for v in scale)

    # de-scaled fast-cell samples -> truncated-Gaussian base (slot level:
    # individually censored slots dropped)
    f1 = T1 / np.asarray(scale)[None, None, :, None]
    f2 = T2 / np.asarray(scale)[None, None, :, None]
    sel = np.broadcast_to(fast[..., None], T1.shape)
    s1 = f1[sel & np.isfinite(f1)]
    s2 = f2[sel & np.isfinite(f2)]
    if s1.size == 0 or s2.size == 0:
        raise ValueError("cannot calibrate: no finite fast-regime delay "
                         "samples survive the fault masking")

    def _tg(x):
        mu, sd = float(x.mean()), float(max(x.std(), 1e-12 * x.mean()))
        a = min(3.0 * sd, 0.999 * mu)                # keep support positive
        return mu, sd, a

    mu1, sd1, a1 = _tg(s1)
    mu2, sd2, a2 = _tg(s2)
    base = TruncatedGaussianDelays(mu1=mu1, sigma1=sd1, a1=a1,
                                   mu2=mu2, sigma2=sd2, a2=a2)
    process = MarkovRegimeProcess(base=base, worker_scale=scale,
                                  p_slow=float(p_slow),
                                  persistence=float(persistence),
                                  slow=float(slow))

    # fit quality: Monte-Carlo moments of the fitted process vs the trace
    F1, F2 = process.sample_rounds(seed, max(int(fit_trials), 1), n, r, R,
                                   device=resolve_device(device))
    F1 = F1.cpu().numpy().astype(np.float64)
    F2 = F2.cpu().numpy().astype(np.float64)

    def rel(a, b):
        return float(abs(a - b) / max(abs(b), 1e-30))

    def fmean(x):                    # finite-cell mean (fault-censor safe)
        f = x[np.isfinite(x)]
        return f.mean() if f.size else np.nan

    worker_err = max(rel(F1[..., i, :].mean(), fmean(T1[..., i, :]))
                     for i in range(n)
                     if np.isfinite(T1[..., i, :]).any())
    return CalibrationReport(
        process=process, worker_scale=scale, p_slow=float(p_slow),
        persistence=float(persistence), slow=float(slow),
        mean_rel_err=rel(F1.mean(), fmean(T1)),
        comm_mean_rel_err=rel(F2.mean(), fmean(T2)),
        worker_mean_rel_err=worker_err,
        lag1_trace=_lag1(m1), lag1_fit=_lag1(F1.mean(axis=3)))
