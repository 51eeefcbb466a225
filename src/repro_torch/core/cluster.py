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
so these processes agree with the JAX ones by distribution.

Faults (``FaultProcess`` and its scenario zoo: ``SpotPreemptionProcess``,
``NetworkPartitionProcess``, ``RackFailureProcess``, ``MessageLossProcess``,
``DiurnalLoadProcess``; ``make_scenario`` builds them with cluster-size
defaults) overlay any base process in-band: a killed or unreachable
worker's delays are +inf, so its results never arrive.
``message_comm_delays`` picks each message's communication draw.

Philox streams (``core/rng.py``), all under the round's seed:

======  ==============================================================
0-4     the delay models' own draws (``core/delays.py``)
5       ``MarkovRegimeProcess``: Bernoulli initial regimes
6       ``MarkovRegimeProcess``: per-round transition uniforms
7       ``AR1Process``: stationary initial latent
8       ``AR1Process``: per-round innovations
9 + d   the per-round uniforms of a fault overlay with ``d`` fault
        overlays below it (preemption, rack and message loss draw; the
        partition and diurnal overlays draw nothing)
======  ==============================================================

A fault overlay hands its base process the same seed and trial ids, so the
base draws exactly what it draws alone: ``kill_p = 0`` or ``p_drop = 0`` is
bit-identical to the base process (the JAX package splits each trial key
into base and fault keys, so there the identity holds in distribution
only).  Stacked overlays (message loss on preemption, or two of one kind)
draw from disjoint streams, one per layer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import numpy as np
import torch

from . import rng
from .delays import DelayModel, TruncatedGaussianDelays, ec2_like

__all__ = [
    "DelayProcess", "IIDProcess", "MarkovRegimeProcess", "AR1Process",
    "as_process", "heterogeneous_scales", "ec2_cluster",
    "message_comm_delays",
    "FaultProcess", "SpotPreemptionProcess", "NetworkPartitionProcess",
    "RackFailureProcess", "MessageLossProcess", "DiurnalLoadProcess",
    "FAULT_SCENARIOS", "make_scenario",
]

State = Any

STREAM_MARKOV_INIT = 5      # Bernoulli initial regimes
STREAM_MARKOV_CHAIN = 6     # per-round transition uniforms
STREAM_AR1_INIT = 7         # stationary initial latent
STREAM_AR1_EPS = 8          # per-round innovations
STREAM_FAULT = 9            # + the overlay's depth: a fault layer's uniforms


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


@dataclasses.dataclass(frozen=True)
class FaultProcess(DelayProcess):
    """Composable failure overlay on any base ``DelayProcess``.

    Faults are in-band: a killed or unreachable worker's delays are +inf,
    so its results never arrive.  The state is ``(base_state,
    fault_state)``; the base steps first under the caller's seed and trial
    ids, then ``fault_step`` rewrites its tables.  A layer's own draws take
    Philox stream ``STREAM_FAULT`` plus the number of fault layers below it
    (``fault_stream``), so overlays stack on any base and on each other.

    Subclasses implement ``fault_init(seed, tids, n)`` and
    ``fault_step(fstate, seed, tids, n, r, T1, T2) -> (fstate, T1, T2)``."""
    base: DelayProcess = dataclasses.field(default_factory=IIDProcess)

    @property
    def fault_stream(self) -> int:
        """This layer's Philox stream: ``STREAM_FAULT`` + its depth."""
        depth, b = 0, self.base
        while isinstance(b, FaultProcess):
            depth, b = depth + 1, b.base
        return STREAM_FAULT + depth

    def fault_init(self, seed, tids: torch.Tensor, n: int) -> State:
        return ()

    def fault_step(self, fstate, seed, tids, n, r, T1, T2):
        raise NotImplementedError

    def init(self, seed, tids, n):
        return (self.base.init(seed, tids, n),
                self.fault_init(seed, tids, n))

    def init_trials(self, seed, tids, n):
        return (self.base.init_trials(seed, tids, n),
                self.fault_init(seed, tids, n))

    def check_rounds(self, rounds):
        self.base.check_rounds(rounds)

    def step(self, state, seed, tids, n, r):
        bstate, fstate = state
        bstate, T1, T2 = self.base.step(bstate, seed, tids, n, r)
        fstate, T1, T2 = self.fault_step(fstate, seed, tids, n, r, T1, T2)
        return (bstate, fstate), T1, T2


def _check_unit(obj, *names):
    for nm in names:
        v = getattr(obj, nm)
        if not 0.0 <= v <= 1.0:
            raise ValueError(f"{nm} must be in [0, 1], got {v}")


@dataclasses.dataclass(frozen=True)
class SpotPreemptionProcess(FaultProcess):
    """Spot-instance preemption: each worker dies with probability
    ``kill_p`` per round and, once dead, respawns with probability
    ``respawn_p`` per round.  A dead worker's compute delays are +inf for
    the round.  ``kill_p = 0`` is the base process, bit for bit."""
    kill_p: float = 0.05
    respawn_p: float = 0.3

    def __post_init__(self):
        _check_unit(self, "kill_p", "respawn_p")

    def fault_init(self, seed, tids, n):
        return torch.ones((tids.shape[0], n), dtype=torch.bool,
                          device=tids.device)     # everyone starts alive

    def fault_step(self, fstate, seed, tids, n, r, T1, T2):
        u = rng.uniform(seed, tids, self.fault_stream, (n,))
        # the chain advances first: the round reflects the new liveness
        alive = torch.where(fstate, u >= self.kill_p, u < self.respawn_p)
        return alive, torch.where(alive[..., None], T1, math.inf), T2


@dataclasses.dataclass(frozen=True)
class NetworkPartitionProcess(FaultProcess):
    """Network partition: the workers in ``workers`` cannot deliver during
    rounds ``[start, start + length)`` — their communication delays are
    +inf while they keep computing."""
    workers: tuple = (0,)
    start: int = 2
    length: int = 5

    def __post_init__(self):
        if not self.workers:
            raise ValueError("partition needs a non-empty worker subset")
        if min(self.workers) < 0:
            raise ValueError(f"negative worker index in {self.workers}")
        if self.start < 0 or self.length <= 0:
            raise ValueError(
                f"need start >= 0 and length > 0, got start={self.start} "
                f"length={self.length}")

    def fault_init(self, seed, tids, n):
        if max(self.workers) >= n:
            raise ValueError(
                f"partition workers {self.workers} out of range for n={n}")
        return 0                                  # round counter

    def fault_step(self, fstate, seed, tids, n, r, T1, T2):
        t = fstate
        if self.start <= t < self.start + self.length:
            member = torch.as_tensor(np.isin(np.arange(n), self.workers),
                                     device=T2.device)
            T2 = torch.where(member[None, :, None], math.inf, T2)
        return t + 1, T1, T2


@dataclasses.dataclass(frozen=True)
class RackFailureProcess(FaultProcess):
    """Correlated rack failure: ``racks[i]`` is worker i's rack, and the
    kill/respawn chain runs per rack — a failed rack's workers die and
    respawn together.  One worker a rack is ``SpotPreemptionProcess``."""
    racks: tuple = (0,)
    kill_p: float = 0.02
    respawn_p: float = 0.5

    def __post_init__(self):
        if not self.racks:
            raise ValueError("racks must map every worker to a rack id")
        if min(self.racks) < 0:
            raise ValueError(f"negative rack id in {self.racks}")
        _check_unit(self, "kill_p", "respawn_p")

    def fault_init(self, seed, tids, n):
        if len(self.racks) != n:
            raise ValueError(
                f"racks maps {len(self.racks)} workers, cluster has {n}")
        return torch.ones((tids.shape[0], max(self.racks) + 1),
                          dtype=torch.bool, device=tids.device)

    def fault_step(self, fstate, seed, tids, n, r, T1, T2):
        u = rng.uniform(seed, tids, self.fault_stream, (max(self.racks) + 1,))
        alive = torch.where(fstate, u >= self.kill_p, u < self.respawn_p)
        rack_of = torch.as_tensor(np.asarray(self.racks, np.int64),
                                  device=T1.device)
        up = alive[:, rack_of][..., None]         # (trials, n, 1)
        return alive, torch.where(up, T1, math.inf), T2


@dataclasses.dataclass(frozen=True)
class MessageLossProcess(FaultProcess):
    """Per-slot Bernoulli message loss: each (worker, slot) result's uplink
    drops with probability ``p_drop``.  Without retry a dropped message
    never arrives (``T2 = +inf``); with ``retry_delay`` the sender re-sends
    after that backoff until a send survives (``floor(log u / log p_drop)``
    failures, geometric)."""
    p_drop: float = 0.1
    retry_delay: float | None = None

    def __post_init__(self):
        if not 0.0 <= self.p_drop < 1.0:
            raise ValueError(f"p_drop must be in [0, 1), got {self.p_drop}")
        if self.retry_delay is not None and self.retry_delay <= 0:
            raise ValueError(
                f"retry_delay must be positive, got {self.retry_delay}")

    def fault_step(self, fstate, seed, tids, n, r, T1, T2):
        u = rng.uniform(seed, tids, self.fault_stream, (n, r))
        if self.retry_delay is None:
            return fstate, T1, torch.where(u < self.p_drop, math.inf, T2)
        if self.p_drop == 0.0:
            return fstate, T1, T2
        fails = torch.floor(torch.log(u) / math.log(self.p_drop))
        return fstate, T1, T2 + fails * self.retry_delay


@dataclasses.dataclass(frozen=True)
class DiurnalLoadProcess(FaultProcess):
    """Diurnal load swell: every delay of round t is multiplied by ``1 +
    amplitude * (1 - cos(2 pi (t + phase) / period)) / 2`` — the whole
    cluster slows together at peak hours; nobody dies.  The factor is one
    float32 scalar a round, computed on the host with numpy in float32
    (the JAX package evaluates the angle and ``cos`` inside XLA: the two
    differ in the last bits, rel 1e-6 at most)."""
    period: int = 24
    amplitude: float = 1.0
    phase: float = 0.0

    def __post_init__(self):
        if self.period <= 0:
            raise ValueError(f"period must be positive, got {self.period}")
        if self.amplitude < 0:
            raise ValueError(
                f"amplitude must be >= 0, got {self.amplitude}")

    def fault_init(self, seed, tids, n):
        return 0

    def factor(self, t: int) -> np.float32:
        """The round-``t`` multiplier, float32."""
        f32 = np.float32
        x = f32(t) + f32(self.phase)
        ang = f32(2.0 * np.pi) * x * f32(1.0 / self.period)
        return f32(1.0) + f32(self.amplitude * 0.5) * (f32(1.0) - np.cos(ang))

    def fault_step(self, fstate, seed, tids, n, r, T1, T2):
        f = float(self.factor(fstate))
        return fstate + 1, T1 * f, T2 * f


FAULT_SCENARIOS = ("preemption", "partition", "rack", "msgloss", "diurnal")


def make_scenario(name: str, base, n: int, **overrides) -> FaultProcess:
    """A named fault scenario over ``base`` (any delay source) with the JAX
    package's cluster-size defaults; ``overrides`` replace any field.
    'preemption' (spot kill/respawn), 'partition' (n//3 workers unreachable
    for rounds 2-7), 'rack' (correlated kills of n//3-sized racks),
    'msgloss' (per-slot Bernoulli drop), 'diurnal' (a cluster-wide
    sinusoidal swell)."""
    proc = as_process(base)
    if name == "preemption":
        kw = {"kill_p": 0.1, "respawn_p": 0.25}
        kw.update(overrides)
        return SpotPreemptionProcess(base=proc, **kw)
    if name == "partition":
        kw = {"workers": tuple(range(max(1, n // 3))),
              "start": 2, "length": 6}
        kw.update(overrides)
        return NetworkPartitionProcess(base=proc, **kw)
    if name == "rack":
        size = max(2, n // 3)
        kw = {"racks": tuple(i // size for i in range(n)),
              "kill_p": 0.05, "respawn_p": 0.3}
        kw.update(overrides)
        return RackFailureProcess(base=proc, **kw)
    if name == "msgloss":
        kw = {"p_drop": 0.1, "retry_delay": None}
        kw.update(overrides)
        return MessageLossProcess(base=proc, **kw)
    if name == "diurnal":
        kw = {"period": 8, "amplitude": 2.0}
        kw.update(overrides)
        return DiurnalLoadProcess(base=proc, **kw)
    raise ValueError(
        f"unknown fault scenario {name!r}; choose from {FAULT_SCENARIOS}")


def message_comm_delays(T2: torch.Tensor, messages: int,
                        eps: float = 0.0) -> torch.Tensor:
    """Per-message communication draws for a round of ``messages`` messages
    a worker: the draw at each message's closing slot.  ``T2`` (..., n, r)
    -> (..., n, messages); ``messages = r`` with ``eps = 0`` returns ``T2``.
    ``eps`` adds the per-message protocol overhead: message ``l``
    (0-indexed) carries ``(l + 1) * eps``."""
    from .montecarlo import message_boundaries
    r = T2.shape[-1]
    if int(messages) == r and not eps:
        return T2
    d = (T2 if int(messages) == r
         else T2[..., torch.as_tensor(message_boundaries(r, messages),
                                      device=T2.device)])
    if eps:
        d = d + eps * torch.arange(1, int(messages) + 1, dtype=T2.dtype,
                                   device=T2.device)
    return d


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
