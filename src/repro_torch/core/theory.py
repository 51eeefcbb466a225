"""Theorem 1 (paper eqs. 7-8), the lower bound (Sec. V) and the
multi-message coded expectations (eqs. 51-57 generalized); counterpart of
``repro.core.theory``, with the same names and signatures and a
``devices=`` argument on the Monte-Carlo wrappers.

Theorem 1 expresses the completion-time tail through joint task-arrival
survival probabilities:

  Pr{t_C(r,k) > t} = sum_{i=n-k+1}^{n} (-1)^{n-k+i+1} C(i-1, n-k)
                     * sum_{S subset [n], |S|=i} Pr{ t_j > t  for all j in S }

* ``theorem1_tail_from_H`` -- the exact combinatorial assembly, given H.
* ``joint_survival_mc``   -- H_S(t) estimated from shared delay samples,
  drawn by the port's engine on ``devices`` (the card by default).  H_S is
  counted where the samples are: the subset's min over its columns, sorted
  once, and the grid placed in it by ``searchsorted``; the exact count over
  ``trials`` in float64 is the JAX package's ``(m[:, None] > t).mean(0)``
  on the same samples.
* ``theorem1_mean_mc``    -- average completion time via Thm 1 + MC H_S.
* ``theorem1_tail_r1_independent`` -- the analytic case r = 1 with
  independent per-worker delays.

The closed forms (``_coef``, ``theorem1_tail_from_H``,
``sum_survival_grid``, ``theorem1_tail_r1_independent``,
``multimessage_*``, ``truncated_gaussian_pdf``,
``operating_point_mean_lb``) stay float64 numpy on the host: they are a few
1-D grids of at most a few thousand points, and Theorem 1's alternating
binomial sums need float64.  They are copies of the JAX package's, in its
order of summation, so they return the same bits.

Multi-message coded completion: with an intra-round message budget ``m`` a
coded worker's r partial computations arrive in ``m`` lumps; the master
decodes once ``threshold`` partials are in.  For i.i.d. workers the tail is
exact given the per-message arrival CDFs under in-order (FIFO) delivery
within each worker (``multimessage_coded_tail``); the engine draws each
message's communication delay independently, so there the closed form is an
approximation whose error grows with the communication dispersion.
"""
from __future__ import annotations

import itertools
import math
from typing import Callable, Sequence

import numpy as np
import torch

from . import montecarlo
from .delays import TruncatedGaussianDelays

__all__ = [
    "theorem1_tail_from_H", "joint_survival_mc", "theorem1_tail_mc",
    "theorem1_mean_mc", "lower_bound_tail_mc", "lower_bound_mean_mc",
    "sum_survival_grid", "theorem1_tail_r1_independent",
    "multimessage_marginal_cdfs", "multimessage_coded_tail",
    "multimessage_coded_mean",
    "truncated_gaussian_pdf", "delay_model_pdfs", "operating_point_mean_lb",
]


def _coef(n: int, k: int, i: int) -> float:
    """(-1)^{n-k+i+1} * binom(i-1, n-k)."""
    return (-1.0) ** (n - k + i + 1) * math.comb(i - 1, n - k)


def theorem1_tail_from_H(H: Callable[[tuple], np.ndarray], n: int, k: int
                         ) -> np.ndarray:
    """Assemble Pr{t_C > t} from per-subset joint survivals.

    ``H(S)`` must return the vector Pr{t_j > t for all j in S} over the
    evaluation grid.  Exponential in n -- fine for the paper-scale n <= 10
    of the tests."""
    out = None
    for i in range(n - k + 1, n + 1):
        c = _coef(n, k, i)
        for S in itertools.combinations(range(n), i):
            h = np.asarray(H(S))
            out = c * h if out is None else out + c * h
    return out


def _survival_counts(m: torch.Tensor, tg: np.ndarray) -> np.ndarray:
    """Pr{m > t} for each t of the grid ``tg`` over the samples ``m``
    (trials,), computed where ``m`` lies: sort once, count the samples at or
    below each t with ``searchsorted`` (exact integers; float32 samples and
    the float64 grid compared in float64, as numpy promotes them), and
    divide the count above t by ``trials`` in float64."""
    srt = torch.sort(m.to(torch.float64)).values
    grid = torch.as_tensor(np.asarray(tg, np.float64), device=m.device)
    below = torch.searchsorted(srt, grid, right=True)
    above = m.shape[0] - below.cpu().numpy().astype(np.int64)
    return above / np.float64(m.shape[0])


def joint_survival_mc(C: np.ndarray, model, tgrid: np.ndarray, *,
                      trials: int = 20000, seed: int = 0,
                      chunk: int | None = None,
                      messages: int | None = None,
                      loads=None, devices=None):
    """Return an ``H(S)`` closure backed by shared MC samples of task
    arrivals, drawn by the port's engine on ``devices`` (the card by
    default; the common random numbers the direct order-statistic
    simulation sees).  ``messages`` sets the per-round message budget
    (Sec. V-C); ``loads`` generalizes to ragged per-worker loads -- a task
    with no active copy never arrives, i.e. survives every ``t``."""
    tau = montecarlo.task_arrival_samples(
        C, model, trials=trials, seed=seed, chunk=chunk, messages=messages,
        loads=loads, devices=devices)                       # (trials, n)
    tg = np.asarray(tgrid)

    def H(S: tuple) -> np.ndarray:
        # all of S exceed t  <=>  their min exceeds t
        m = tau[:, list(S)].amin(dim=1)
        return _survival_counts(m, tg)

    return H


def theorem1_tail_mc(C, model, tgrid, *, trials=20000, seed=0, k,
                     messages=None, loads=None, devices=None):
    """Pr{t_C(r, k) > t} over ``tgrid`` via Theorem 1 with MC-estimated
    joint survivals.  ``k`` is a required keyword (the computation
    target); ``loads`` generalizes to ragged per-worker loads."""
    n = np.asarray(C).shape[0]
    if not isinstance(k, (int, np.integer)) or not 1 <= int(k) <= n:
        raise ValueError(
            f"k must be an integer computation target in [1, n={n}]; got "
            f"k={k!r}")
    H = joint_survival_mc(C, model, tgrid, trials=trials, seed=seed,
                          messages=messages, loads=loads, devices=devices)
    return theorem1_tail_from_H(H, n, int(k))


def theorem1_mean_mc(C, model, k: int, *, tmax: float, npts: int = 512,
                     trials: int = 20000, seed: int = 0,
                     messages: int | None = None, loads=None,
                     devices=None) -> float:
    """Average completion time via eq. (8): integral of the tail."""
    tgrid = np.linspace(0.0, tmax, npts)
    tail = theorem1_tail_mc(C, model, tgrid, trials=trials, seed=seed, k=k,
                            messages=messages, loads=loads, devices=devices)
    return float(np.trapezoid(np.clip(tail, 0.0, 1.0), tgrid))


def lower_bound_tail_mc(model, n: int, k: int, tgrid, *, r: int | None = None,
                        loads=None, messages: int | None = None,
                        trials: int = 20000, seed: int = 0,
                        devices=None) -> np.ndarray:
    """Pr{t_LB(k) > t}: the oracle lower bound (eq. 46) generalized to a
    per-worker load vector -- the k-th order statistic over all
    ``sum(loads)`` active slot arrivals, estimated from engine samples."""
    samples = montecarlo.completion_samples(
        montecarlo.lb_spec(r, loads=loads, messages=messages), model, n,
        trials=trials, seed=seed, k=k, devices=devices)
    return _survival_counts(samples, np.asarray(tgrid))


def lower_bound_mean_mc(model, n: int, k: int, *, r: int | None = None,
                        loads=None, messages: int | None = None,
                        trials: int = 20000, seed: int = 0,
                        devices=None) -> float:
    """Average oracle lower bound (eq. 46) at load ``r`` or ragged load
    vector ``loads`` (paired with the uncoded schemes' draws under common
    random numbers)."""
    samples = montecarlo.completion_samples(
        montecarlo.lb_spec(r, loads=loads, messages=messages), model, n,
        trials=trials, seed=seed, k=k, devices=devices)
    return float(samples.cpu().numpy().mean())


# -------- analytic special case: r = 1, independent delays -------------------

def sum_survival_grid(pdf1: Callable[[np.ndarray], np.ndarray],
                      pdf2: Callable[[np.ndarray], np.ndarray],
                      tmax: float, npts: int = 4096):
    """Survival function of T1 + T2 for independent T1, T2 with the given
    densities, on a uniform grid via discrete convolution.  Returns (tgrid,
    survival)."""
    t = np.linspace(0.0, tmax, npts)
    dt = t[1] - t[0]
    f1 = pdf1(t)
    f2 = pdf2(t)
    fsum = np.convolve(f1, f2)[:npts] * dt          # density of the sum
    cdf = np.cumsum(fsum) * dt
    return t, np.clip(1.0 - cdf, 0.0, 1.0)


def theorem1_tail_r1_independent(survivals: Sequence[np.ndarray], k: int
                                 ) -> np.ndarray:
    """r = 1, independent workers: worker i computes only task i, so
    t_j = T1_j + T2_j independent across j and H_S(t) = prod_{j in S}
    S_j(t).  ``survivals[j]`` is S_j over the grid."""
    n = len(survivals)
    S_ = [np.asarray(s) for s in survivals]

    def H(Sset: tuple) -> np.ndarray:
        out = np.ones_like(S_[0])
        for j in Sset:
            out = out * S_[j]
        return out

    return theorem1_tail_from_H(H, n, k)


# -------- multi-message coded completion (eqs. 51-52 / 56-57 generalized) ----

def _convolve_density(f: np.ndarray, g: np.ndarray, dt: float) -> np.ndarray:
    """Density of the sum of two independent variables on the same uniform
    grid (discrete convolution, truncated to the grid)."""
    return np.convolve(f, g)[:len(f)] * dt


def multimessage_marginal_cdfs(pdf1: Callable[[np.ndarray], np.ndarray],
                               pdf2: Callable[[np.ndarray], np.ndarray],
                               r: int, messages: int, tmax: float,
                               npts: int = 2048
                               ) -> tuple[np.ndarray, np.ndarray]:
    """Per-message arrival CDFs of ONE worker on a uniform grid.

    Message ``l`` closes at slot ``b_l`` (``montecarlo.message_boundaries``):
    its arrival is the sum of ``b_l + 1`` i.i.d. per-slot compute delays
    (density ``pdf1``) plus one per-message communication draw (``pdf2``).
    Returns ``(tgrid, F)`` with ``F`` of shape ``(messages, npts)``."""
    t = np.linspace(0.0, tmax, npts)
    dt = t[1] - t[0]
    f1 = pdf1(t)
    f2 = pdf2(t)
    bounds = montecarlo.message_boundaries(r, messages)
    F = np.zeros((messages, npts))
    comp = None                       # density of the cumulative compute sum
    nxt = 0
    for j in range(r):
        comp = f1 if comp is None else _convolve_density(comp, f1, dt)
        if nxt < messages and bounds[nxt] == j:
            dens = _convolve_density(comp, f2, dt)
            F[nxt] = np.clip(np.cumsum(dens) * dt, 0.0, 1.0)
            nxt += 1
    return t, F


def multimessage_coded_tail(F: np.ndarray, group_sizes: Sequence[int],
                            n: int, threshold: int) -> np.ndarray:
    """Pr{completion > t} of the multi-message coded scheme under FIFO
    (in-order) message delivery within each worker.

    ``n`` i.i.d. workers; a worker's message ``l`` delivers
    ``group_sizes[l]`` coded partials in one lump, with arrival CDF ``F[l]``
    (a row per message, columns = time grid); the master decodes once
    ``threshold`` partials arrived.  A worker's delivered-unit count at t has
    pmf {P(N=0)=1-F[0], P(N=c_l)=F[l]-F[l+1], P(N=c_m)=F[m-1]} over the
    cumulative counts c_l; the total across workers is that pmf convolved n
    times (counts >= threshold are absorbed) and the tail is Pr{total <
    threshold}."""
    F = np.asarray(F, np.float64)
    m, T = F.shape
    gs = [int(g) for g in group_sizes]
    if len(gs) != m or min(gs) < 1:
        raise ValueError(f"need {m} positive group sizes, got {gs}")
    cum = np.cumsum(gs)
    th = int(threshold)
    if not 1 <= th <= n * int(cum[-1]):
        raise ValueError(f"need 1 <= threshold <= n*r={n * int(cum[-1])}, "
                         f"got {th}")
    probs = np.empty((m + 1, T))
    probs[0] = 1.0 - F[0]
    for l in range(m - 1):
        probs[l + 1] = F[l] - F[l + 1]
    probs[m] = F[m - 1]
    probs = np.clip(probs, 0.0, 1.0)
    counts = [0] + [int(c) for c in cum]
    poly = np.zeros((th, T))          # poly[u] = Pr{units so far == u}
    poly[0] = 1.0
    for _ in range(n):
        new = np.zeros_like(poly)
        for c, p in zip(counts, probs):
            if c < th:                # counts past th are absorbed (done)
                new[c:] += p * poly[:th - c]
        poly = new
    return poly.sum(axis=0)           # Pr{units < threshold}


def _shift_message_cdfs(t: np.ndarray, F: np.ndarray,
                        comm_eps: float) -> np.ndarray:
    """Fold the per-message protocol overhead into the arrival CDFs:
    message ``l`` lands ``(l + 1) * comm_eps`` late, i.e. its CDF shifts
    right by that amount on the grid."""
    if not comm_eps:
        return F
    return np.stack([np.interp(t - (l + 1) * comm_eps, t, F[l], left=0.0)
                     for l in range(F.shape[0])])


def multimessage_coded_mean(n: int, r: int, messages: int,
                            pdf1: Callable[[np.ndarray], np.ndarray],
                            pdf2: Callable[[np.ndarray], np.ndarray], *,
                            tmax: float, npts: int = 2048,
                            threshold: int | None = None,
                            comm_eps: float = 0.0) -> float:
    """Average completion time of the multi-message coded scheme with
    ``messages`` messages per worker under i.i.d. per-slot compute delays
    (``pdf1``), per-message communication delays (``pdf2``) and FIFO
    delivery within each worker.  ``threshold=None`` uses PCMM's ``2n - 1``
    partials (eqs. 56-57); PC's one-shot expectation (eqs. 51-52) is
    ``messages=1`` with ``threshold=(2*ceil(n/r) - 2) * r + 1``."""
    t, F = multimessage_marginal_cdfs(pdf1, pdf2, r, messages, tmax, npts)
    F = _shift_message_cdfs(t, F, comm_eps)
    gs = montecarlo.message_group_sizes(r, messages)
    th = 2 * n - 1 if threshold is None else int(threshold)
    tail = multimessage_coded_tail(F, gs, n, th)
    return float(np.trapezoid(np.clip(tail, 0.0, 1.0), t))


# -------- planner dominance guides --------------------------------------------

def truncated_gaussian_pdf(mu: float, sigma: float, a: float,
                           b: float | None = None
                           ) -> Callable[[np.ndarray], np.ndarray]:
    """Density of ``N(mu, sigma^2)`` truncated to ``[mu - a, mu + b]``
    (``b`` defaults to ``a``, the paper's symmetric truncation) -- the
    closed-form marginal of ``TruncatedGaussianDelays`` with scalar mean and
    ``rho == 0``."""
    b = a if b is None else b
    lo, hi = mu - a, mu + b
    sq2 = math.sqrt(2.0)
    Z = 0.5 * (math.erf((hi - mu) / (sigma * sq2))
               - math.erf((lo - mu) / (sigma * sq2)))
    norm = sigma * math.sqrt(2.0 * math.pi) * Z

    def pdf(t: np.ndarray) -> np.ndarray:
        t = np.asarray(t, np.float64)
        z = (t - mu) / sigma
        d = np.exp(-0.5 * z * z) / norm
        return np.where((t >= lo) & (t <= hi), d, 0.0)

    return pdf


def delay_model_pdfs(model):
    """``(pdf1, pdf2, sup1, sup2)`` -- closed-form per-slot compute and
    per-message communication densities plus their supports' upper ends --
    for the port's ``TruncatedGaussianDelays`` with scalar means and
    ``rho == 0``; ``None`` otherwise (per-worker mean vectors or correlated
    slots have no shared i.i.d. marginal)."""
    if not isinstance(model, TruncatedGaussianDelays) or model.rho:
        return None
    if not (np.isscalar(model.mu1) and np.isscalar(model.mu2)):
        return None
    b1 = model.a1 if model.b1 is None else model.b1
    b2 = model.a2 if model.b2 is None else model.b2
    pdf1 = truncated_gaussian_pdf(float(model.mu1), model.sigma1,
                                  model.a1, b1)
    pdf2 = truncated_gaussian_pdf(float(model.mu2), model.sigma2,
                                  model.a2, b2)
    return pdf1, pdf2, float(model.mu1) + b1, float(model.mu2) + b2


def operating_point_mean_lb(n: int, r: int, k: int,
                            pdf1: Callable[[np.ndarray], np.ndarray],
                            pdf2: Callable[[np.ndarray], np.ndarray], *,
                            messages: int | None = None,
                            comm_eps: float = 0.0, tmax: float,
                            npts: int = 1024) -> float:
    """Closed-form guide for the oracle lower bound (eq. 46) at one
    operating point: the mean time until ``k`` slot results arrived,
    counting every one of the ``n * r`` slots' arrivals grouped into
    ``min(messages, r)`` messages per worker (message ``l`` shifted by the
    ``(l + 1) * comm_eps`` protocol overhead).  Distinctness of the
    delivered tasks is ignored (the engine's ``lb_spec`` semantics); like
    ``multimessage_coded_tail`` it assumes in-order message delivery within
    a worker, so it is a guide."""
    m_eff = r if messages is None else int(min(messages, r))
    t, F = multimessage_marginal_cdfs(pdf1, pdf2, r, m_eff, tmax, npts)
    F = _shift_message_cdfs(t, F, comm_eps)
    gs = montecarlo.message_group_sizes(r, m_eff)
    tail = multimessage_coded_tail(F, gs, n, int(k))
    return float(np.trapezoid(np.clip(tail, 0.0, 1.0), t))
