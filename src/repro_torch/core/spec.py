"""The canonical round configuration — one frozen ``RoundConfig`` and one
validator; counterpart of ``repro.core.spec``.

The validator is the JAX package's, field for field, so a configuration
valid on one side is valid on the other and the JSON document round-trips
between them.  The port has no deprecated ``RoundSpec``/``SchemeSpec``
shims: its aggregator takes a ``RoundConfig`` and its engine builds specs
through the factories.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

import numpy as np

from . import scheduling

__all__ = [
    "RoundConfig",
    "DEADLINE_POLICIES",
    "validate_deadline",
]

#: the fallback policies a deadline-capped round may close under.
DEADLINE_POLICIES = ("wait", "close_partial", "reissue")

CONFIG_FORMAT = "repro.round_config"
CONFIG_VERSION = 1


def validate_deadline(deadline, deadline_policy: str) -> Optional[float]:
    """Canonical deadline/policy validation.  Returns the deadline as
    ``float`` (or ``None``)."""
    if deadline_policy not in DEADLINE_POLICIES:
        raise ValueError(f"deadline_policy: unknown deadline policy "
                         f"{deadline_policy!r}; choose from "
                         f"{DEADLINE_POLICIES}")
    if deadline is not None:
        deadline = float(deadline)
        if not deadline > 0:
            raise ValueError(f"deadline must be > 0, got {deadline}")
    elif deadline_policy != "wait":
        raise ValueError(f"deadline_policy={deadline_policy!r} needs a "
                         f"deadline")
    return deadline


@dataclasses.dataclass(frozen=True)
class RoundConfig:
    """Everything that defines one distributed-SGD round, validated once.

    Scheme/shape: ``kind`` names the TO-matrix family (``cs`` | ``ss`` |
    ``ra`` | ``block``); ``n`` is the number of tasks (= workers), ``k``
    the distinct results a round needs, ``r`` the slot-grid width (per-
    worker load cap; ``None`` = ``n``), ``loads`` per-worker loads (ragged
    rounds — for ``rebalance`` the *initial budget* under the cap ``r``),
    ``messages`` the per-round message budget (``None`` = one per slot),
    ``comm_eps`` the serialized per-message protocol overhead.

    Deadlines: ``deadline`` caps each round's wall-clock, ``deadline_policy``
    picks the fallback (``wait`` | ``close_partial`` | ``reissue``).

    Adaptivity: ``adaptive`` re-assigns the base matrix's rows each round
    from delay feedback, ``censored_feedback`` restricts that feedback to
    what a real master observes, ``rebalance`` re-allocates whole slots
    between workers, ``dead_after`` marks silent workers dead after that
    many rounds, ``feedback_beta`` / ``coverage_gamma`` tune the scheduler.
    The port's aggregator and engine run all of them.

    ``seed`` seeds RA-matrix construction.
    """
    n: int
    k: int
    kind: str = "cs"
    r: Optional[int] = None
    loads: Optional[tuple] = None
    messages: Optional[int] = None
    comm_eps: float = 0.0
    deadline: Optional[float] = None
    deadline_policy: str = "wait"
    adaptive: bool = False
    rebalance: bool = False
    censored_feedback: bool = False
    dead_after: Optional[int] = None
    feedback_beta: float = 0.7
    coverage_gamma: float = 0.5
    seed: int = 0

    def __post_init__(self):
        _set = object.__setattr__
        _set(self, "n", int(self.n))
        _set(self, "k", int(self.k))
        _set(self, "kind", str(self.kind))
        _set(self, "r", None if self.r is None else int(self.r))
        _set(self, "messages",
             None if self.messages is None else int(self.messages))
        _set(self, "comm_eps", float(self.comm_eps))
        _set(self, "adaptive", bool(self.adaptive))
        _set(self, "rebalance", bool(self.rebalance))
        _set(self, "censored_feedback", bool(self.censored_feedback))
        _set(self, "dead_after",
             None if self.dead_after is None else int(self.dead_after))
        _set(self, "feedback_beta", float(self.feedback_beta))
        _set(self, "coverage_gamma", float(self.coverage_gamma))
        _set(self, "seed", int(self.seed))
        if not (1 <= self.k <= self.n):
            raise ValueError(f"need 1 <= k <= n; got k={self.k}, n={self.n}")
        r = self.width
        if not (1 <= r <= self.n):
            raise ValueError(f"need 1 <= r <= n; got r={r}, n={self.n}")
        if self.messages is not None and not 1 <= self.messages <= r:
            raise ValueError(f"need 1 <= messages <= r={r}; got "
                             f"messages={self.messages}")
        if self.comm_eps < 0:
            raise ValueError(f"comm_eps must be >= 0, got {self.comm_eps}")
        _set(self, "deadline",
             validate_deadline(self.deadline, self.deadline_policy))
        if self.loads is not None:
            _set(self, "loads", tuple(int(v) for v in self.loads))
            lv = np.asarray(self.loads, np.int64)
            if lv.shape != (self.n,) or lv.min() < 1 or lv.max() > r:
                raise ValueError(f"loads must be ({self.n},) with 1 <= load "
                                 f"<= r={r}; got {self.loads}")
            if self.kind not in ("cs", "ss", "ra"):
                raise ValueError(
                    f"ragged loads need a slot-0-diagonal schedule (cs / ss "
                    f"/ ra) so every task stays covered; got {self.kind!r}")
        if not 0.0 <= self.feedback_beta < 1.0:
            raise ValueError(f"feedback_beta must be in [0, 1), got "
                             f"{self.feedback_beta}")
        if not 0.0 <= self.coverage_gamma <= 1.0:
            raise ValueError(f"coverage_gamma must be in [0, 1], got "
                             f"{self.coverage_gamma}")
        if self.censored_feedback and not self.adaptive:
            raise ValueError("censored_feedback requires adaptive=True — "
                             "static schedules take no feedback to censor")
        if self.rebalance and not self.adaptive:
            raise ValueError("rebalance requires adaptive=True — load "
                             "re-allocation is feedback-driven")
        if self.dead_after is not None:
            if not self.adaptive:
                raise ValueError("dead_after requires adaptive=True — crash "
                                 "detection feeds the adaptive scheduler")
            if self.dead_after < 1:
                raise ValueError(f"dead_after must be >= 1, got "
                                 f"{self.dead_after}")
        if self.deadline_policy == "reissue" and not self.adaptive:
            raise ValueError("deadline_policy='reissue' requires "
                             "adaptive=True — re-gathering undelivered "
                             "tasks is a scheduling decision")
        if self.rebalance and self.loads is None:
            raise ValueError("rebalance needs loads as the initial budget "
                             "below the cap r")
        if self.rebalance and self.comm_eps:
            raise ValueError("rebalance does not support comm_eps yet")
        if self.adaptive and self.comm_eps:
            raise ValueError("comm_eps with adaptive scheduling is not "
                             "supported yet (expected_completion could not "
                             "estimate the policy actually run)")
        # the masked assignment must still be able to deliver k distinct
        # results — catch impossible rounds up front.
        C = self.to_matrix()
        covered = int(np.unique(C[C >= 0]).size)
        if covered < self.k:
            raise ValueError(
                f"schedule {self.kind!r} with loads={self.loads} covers "
                f"only {covered} distinct tasks < k={self.k} "
                f"({self.k - covered} short): no round can ever complete; "
                f"lower k or raise the per-worker loads")
        if self.rebalance and sorted(
                self.base_matrix()[:, 0].tolist()) != list(range(self.n)):
            raise ValueError("rebalance needs a slot-0-diagonal base "
                             "schedule (cs / ss) so every task stays "
                             "covered under any load vector")

    # ------------------------------ derived ----------------------------------

    @property
    def width(self) -> int:
        """The resolved slot-grid width (``r``; ``None`` resolves to ``n``)."""
        return self.n if self.r is None else self.r

    @property
    def n_messages(self) -> int:
        return self.width if self.messages is None else self.messages

    @property
    def load_vector(self) -> np.ndarray:
        return (np.full(self.n, self.width, np.int64) if self.loads is None
                else np.asarray(self.loads, np.int64))

    def base_matrix(self) -> np.ndarray:
        """The dense (un-masked) schedule at the grid width."""
        kw = {"seed": self.seed} if self.kind == "ra" else {}
        return scheduling.to_matrix(self.kind, self.n, self.width, **kw)

    def to_matrix(self) -> np.ndarray:
        """The effective schedule with ragged loads baked in as trailing
        ``MASKED`` sentinels."""
        kw = {"seed": self.seed} if self.kind == "ra" else {}
        if self.loads is not None:
            kw["loads"] = self.loads
        return scheduling.to_matrix(self.kind, self.n, self.width, **kw)

    def to_scheme_spec(self, name: Optional[str] = None):
        """The engine's ``SchemeSpec`` for this round: ``adaptive_spec``
        (base matrix + feedback re-planning) for adaptive configs,
        ``to_spec`` for static ones."""
        from . import montecarlo
        nm = self.kind if name is None else name
        if self.adaptive:
            return montecarlo.adaptive_spec(
                nm, self.base_matrix(), messages=self.messages,
                loads=self.loads, rebalance=self.rebalance)
        return montecarlo.to_spec(
            nm, self.base_matrix(), messages=self.messages, loads=self.loads,
            comm_eps=self.comm_eps)

    def sweep_rounds_kwargs(self) -> dict:
        """Keyword arguments for ``montecarlo.sweep_rounds`` /
        ``trajectory_samples`` matching this config's round semantics."""
        kw = dict(k=self.k, feedback_beta=self.feedback_beta,
                  coverage_gamma=self.coverage_gamma,
                  censored_feedback=self.censored_feedback)
        if self.deadline is not None:
            kw.update(deadline=self.deadline,
                      deadline_policy=self.deadline_policy)
        return kw

    def aggregator_kwargs(self) -> dict:
        """This config's adaptivity as keyword arguments, the JAX
        package's ``StragglerAggregator`` form (the port's aggregator reads
        them from the ``RoundConfig`` itself)."""
        return dict(adaptive=self.adaptive,
                    feedback_beta=self.feedback_beta,
                    coverage_gamma=self.coverage_gamma,
                    censored_feedback=self.censored_feedback,
                    rebalance=self.rebalance,
                    dead_after=self.dead_after)

    # ------------------------------ JSON form --------------------------------

    def to_dict(self) -> dict:
        d = {"format": CONFIG_FORMAT, "version": CONFIG_VERSION}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            d[f.name] = list(v) if isinstance(v, tuple) else v
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "RoundConfig":
        d = dict(d)
        fmt = d.pop("format", CONFIG_FORMAT)
        if fmt != CONFIG_FORMAT:
            raise ValueError(f"not a round config document: format={fmt!r} "
                             f"(expected {CONFIG_FORMAT!r})")
        version = int(d.pop("version", CONFIG_VERSION))
        if version > CONFIG_VERSION:
            raise ValueError(f"round config version {version} is newer than "
                             f"this library supports ({CONFIG_VERSION})")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown round config fields: {unknown}")
        if d.get("loads") is not None:
            d["loads"] = tuple(int(v) for v in d["loads"])
        return cls(**d)

    def to_json(self, *, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "RoundConfig":
        return cls.from_dict(json.loads(text))

    def save(self, path) -> None:
        Path(path).write_text(self.to_json() + "\n")

    @classmethod
    def load(cls, path) -> "RoundConfig":
        return cls.from_json(Path(path).read_text())
