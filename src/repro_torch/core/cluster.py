"""Round-aware cluster delay processes, IID part; counterpart of the
``DelayProcess`` / ``IIDProcess`` / ``as_process`` part of
``repro.core.cluster``.

A ``DelayProcess`` is the stateful generalization of a ``DelayModel``:

    state            = process.init(seed, tids, n)
    state, T1, T2    = process.step(state, seed, tids, n, r)

``(seed, tids)`` identifies one random stream per trial (the engine's
common-random-numbers convention: the JAX package passes one PRNG key per
trial), ``T1``/``T2`` keep the ``(trials, n, r)`` layout.  The Markov, AR1
and fault processes wait for the port's rounds slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from .delays import DelayModel, TruncatedGaussianDelays

__all__ = ["DelayProcess", "IIDProcess", "as_process"]

State = Any


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


def as_process(delay) -> DelayProcess:
    """Coerce a delay source into a ``DelayProcess``: processes pass through,
    a stateless ``DelayModel`` becomes ``IIDProcess``."""
    if isinstance(delay, DelayProcess):
        return delay
    if isinstance(delay, DelayModel):
        return IIDProcess(delay)
    raise TypeError(
        f"cannot interpret {type(delay).__name__!r} as a delay source: "
        f"expected a DelayProcess (init/step protocol, e.g. IIDProcess) or "
        f"a stateless DelayModel (e.g. TruncatedGaussianDelays); got "
        f"{delay!r}")
