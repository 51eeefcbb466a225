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

Recording a trace from a sweep (``record_trace=True``) and
``calibrate_trace`` wait for a later slice of the port.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Optional

import numpy as np
import torch

from .cluster import DelayProcess

__all__ = ["TRACE_FORMAT_VERSION", "DelayTrace", "TraceProcess",
           "save_trace", "load_trace", "validate_trace_file"]

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
