"""Round-aware cluster delay processes — stateful straggling across SGD
rounds; counterpart of the process part of ``repro.core.cluster``.

A ``DelayProcess`` is the stateful generalization of a ``DelayModel``:

    state            = process.init(seed, tids, n)
    state, T1, T2    = process.step(state, seed, tids, n, r)

``(seed, tids)`` identifies one random stream per trial (the engine's
common-random-numbers convention: the JAX package passes one PRNG key per
trial), ``T1``/``T2`` keep the ``(trials, n, r)`` layout.  A multi-round caller
passes ``rng.round_seed(seed, 0)`` to ``init`` and ``rng.round_seed(seed,
t + 1)`` to round ``t``'s ``step``.

Processes: ``IIDProcess`` (a stateless ``DelayModel``), the persistent
fast/slow ``MarkovRegimeProcess`` and the drifting ``AR1Process``;
``heterogeneous_scales`` and ``ec2_cluster`` build the realistic
heterogeneous cluster.  The two frameworks draw different random numbers,
so these processes agree with the JAX ones by distribution.  Their own
Philox streams lie above the delay models' streams 0-4: the Markov chain's
Bernoulli initial regimes take stream 5 and its per-round transition
uniforms stream 6; the AR(1) latent's initial normals take stream 7 and its
per-round innovations stream 8.  The base model's draws keep their own
streams under the round's seed.  The fault processes, ``make_scenario`` and
``message_comm_delays`` wait for a later slice of the port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import numpy as np
import torch

from . import rng
from .delays import DelayModel, TruncatedGaussianDelays, ec2_like

__all__ = ["DelayProcess", "IIDProcess", "MarkovRegimeProcess",
           "AR1Process", "as_process", "heterogeneous_scales",
           "ec2_cluster"]

State = Any

STREAM_MARKOV_INIT = 5      # Bernoulli initial regimes
STREAM_MARKOV_CHAIN = 6     # per-round transition uniforms
STREAM_AR1_INIT = 7         # stationary initial latent
STREAM_AR1_EPS = 8          # per-round innovations


def _scale_column(worker_scale, n: int, device) -> torch.Tensor:
    """Per-worker speed multipliers broadcast to the (trials, n, r)
    layout."""
    w = torch.as_tensor(np.asarray(worker_scale, np.float32), device=device)
    return torch.broadcast_to(w, (n,)).reshape(1, n, 1)


@dataclasses.dataclass(frozen=True)
class DelayProcess:
    """Base class.  Subclasses implement ``init``/``step``."""

    def init(self, seed: int, tids: torch.Tensor, n: int) -> State:
        raise NotImplementedError

    def init_trials(self, seed: int, tids: torch.Tensor, n: int) -> State:
        """``init`` with explicit global trial indices (the form the
        engines call).  Parametric processes are determined by their
        per-trial streams; a replayed trace would read its trial ``tids``."""
        return self.init(seed, tids, n)

    def check_rounds(self, rounds: int) -> None:
        """Hook for finite delay sources: raise if a ``rounds``-long run
        cannot be served.  Parametric processes are unbounded (no-op)."""

    def step(self, state: State, seed: int, tids: torch.Tensor, n: int,
             r: int) -> Tuple[State, torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def sample_rounds(self, seed: int, trials: int, n: int, r: int,
                      rounds: int, *, device=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Convenience: unroll the process over trials ``0..trials-1``,
        returning delay tensors of shape ``(rounds, trials, n, r)``."""
        from ..device import resolve_device
        self.check_rounds(rounds)
        tids = torch.arange(trials, dtype=torch.int64,
                            device=resolve_device(device))
        state = self.init_trials(rng.round_seed(seed, 0), tids, n)
        T1s, T2s = [], []
        for t in range(rounds):
            state, T1, T2 = self.step(state, rng.round_seed(seed, t + 1),
                                      tids, n, r)
            T1s.append(T1)
            T2s.append(T2)
        return torch.stack(T1s), torch.stack(T2s)


@dataclasses.dataclass(frozen=True)
class IIDProcess(DelayProcess):
    """A stateless ``DelayModel`` as a (trivially stateful) process — the
    zero-correlation special case."""
    model: DelayModel = TruncatedGaussianDelays()

    def init(self, seed, tids, n):
        return ()

    def step(self, state, seed, tids, n, r):
        T1, T2 = self.model.sample(seed, tids, n, r)
        return (), T1, T2


@dataclasses.dataclass(frozen=True)
class MarkovRegimeProcess(DelayProcess):
    """Per-worker fast/slow regime chain with persistent stragglers.

    Each worker carries a two-state Markov chain; in the slow regime all of
    its delays (compute and communication) are multiplied by ``slow``.
    ``p_slow`` is the stationary slow probability and ``persistence`` =
    1 - p_fast_to_slow - p_slow_to_fast the chain's one-step
    autocorrelation (0: regimes i.i.d. across rounds; 1: frozen at the
    stationary initial draw).  ``worker_scale`` (scalar or length-n tuple)
    multiplies every delay of worker i.  The chain starts from its
    stationary distribution and advances before each round is sampled."""
    base: DelayModel = TruncatedGaussianDelays()
    worker_scale: tuple | float = 1.0
    p_slow: float = 0.2
    persistence: float = 0.9
    slow: float = 5.0

    def __post_init__(self):
        if not 0.0 <= self.p_slow <= 1.0:
            raise ValueError(f"p_slow must be in [0, 1], got {self.p_slow}")
        if not 0.0 <= self.persistence <= 1.0:
            raise ValueError(
                f"persistence must be in [0, 1], got {self.persistence}")

    @property
    def _p_fs(self) -> float:            # fast -> slow
        return (1.0 - self.persistence) * self.p_slow

    @property
    def _p_sf(self) -> float:            # slow -> fast
        return (1.0 - self.persistence) * (1.0 - self.p_slow)

    def init(self, seed, tids, n):
        u = rng.uniform(seed, tids, STREAM_MARKOV_INIT, (n,))
        return u < self.p_slow                            # (trials, n) bool

    def step(self, state, seed, tids, n, r):
        u = rng.uniform(seed, tids, STREAM_MARKOV_CHAIN, (n,))
        slow_now = torch.where(state, u >= self._p_sf, u < self._p_fs)
        T1, T2 = self.base.sample(seed, tids, n, r)
        f = torch.where(slow_now[..., None], float(self.slow), 1.0)
        f = f * _scale_column(self.worker_scale, n, T1.device)
        return slow_now, T1 * f, T2 * f


@dataclasses.dataclass(frozen=True)
class AR1Process(DelayProcess):
    """Smoothly drifting worker speeds: a per-worker AR(1) latent
    ``x' = rho * x + sigma * sqrt(1 - rho^2) * eps`` (stationary
    N(0, sigma^2)) multiplies delays by ``exp(x - sigma^2 / 2)``.
    ``worker_scale`` as in ``MarkovRegimeProcess``."""
    base: DelayModel = TruncatedGaussianDelays()
    worker_scale: tuple | float = 1.0
    rho: float = 0.9
    sigma: float = 0.3

    def __post_init__(self):
        if not -1.0 < self.rho < 1.0:
            raise ValueError(f"rho must be in (-1, 1), got {self.rho}")

    def init(self, seed, tids, n):
        return self.sigma * rng.normal(seed, tids, STREAM_AR1_INIT, (n,))

    def step(self, state, seed, tids, n, r):
        eps = rng.normal(seed, tids, STREAM_AR1_EPS, (n,))
        x = self.rho * state + self.sigma * math.sqrt(1.0 - self.rho ** 2) * eps
        T1, T2 = self.base.sample(seed, tids, n, r)
        f = torch.exp(x - 0.5 * self.sigma ** 2)[..., None]
        f = f * _scale_column(self.worker_scale, n, T1.device)
        return x, T1 * f, T2 * f


def as_process(delay) -> DelayProcess:
    """Coerce a delay source into a ``DelayProcess``: processes pass through,
    a stateless ``DelayModel`` becomes ``IIDProcess``, a recorded
    ``DelayTrace`` becomes a ``TraceProcess``."""
    if isinstance(delay, DelayProcess):
        return delay
    if isinstance(delay, DelayModel):
        return IIDProcess(delay)
    from .trace import DelayTrace, TraceProcess    # late: trace imports us
    if isinstance(delay, DelayTrace):
        return TraceProcess(delay)
    raise TypeError(
        f"cannot interpret {type(delay).__name__!r} as a delay source: "
        f"expected a DelayProcess (init/step protocol, e.g. IIDProcess, "
        f"MarkovRegimeProcess, AR1Process, TraceProcess), a stateless "
        f"DelayModel (e.g. TruncatedGaussianDelays), or a recorded "
        f"DelayTrace; got {delay!r}")


def heterogeneous_scales(n: int, spread: float = 2.0, seed: int = 0) -> tuple:
    """Per-worker speed multipliers geometrically spread over
    ``[1/sqrt(spread), sqrt(spread)]`` (geometric mean 1), randomly permuted
    so worker index carries no information.  ``spread=1`` is homogeneous."""
    if spread < 1.0:
        raise ValueError(f"spread must be >= 1, got {spread}")
    if n == 1 or spread == 1.0:
        return tuple([1.0] * n)
    gen = np.random.default_rng(seed)
    log_s = np.linspace(-0.5, 0.5, n) * np.log(spread)
    return tuple(np.exp(gen.permutation(log_s)).tolist())


def ec2_cluster(n: int, *, spread: float = 2.0, p_slow: float = 0.2,
                persistence: float = 0.9, slow: float = 5.0,
                base: DelayModel | None = None,
                seed: int = 0) -> MarkovRegimeProcess:
    """A realistic heterogeneous, persistent-straggler cluster: the
    EC2-calibrated truncated-Gaussian base (``ec2_like``), a machine-speed
    spread, and a sticky slow/fast regime chain."""
    if base is None:
        base = ec2_like(n, seed=seed)
    return MarkovRegimeProcess(
        base=base, worker_scale=heterogeneous_scales(n, spread, seed),
        p_slow=p_slow, persistence=persistence, slow=slow)
