"""Task-ordering (TO) matrices, static half; counterpart of
``repro.core.scheduling`` (numpy, so the port's matrices equal the JAX
package's exactly, RA seeds included).

A TO matrix ``C`` is an ``(n, r)`` integer matrix.  Row ``i`` lists the task
indices worker ``i`` executes, in order (paper Sec. II); tasks are
0-indexed.  Ragged per-worker loads keep the grid rectangular: row ``i``'s
trailing ``r_max - loads[i]`` slots hold the sentinel ``MASKED`` (-1).

Implemented schedules:
  * Cyclic scheduling   (CS, paper eq. 21):  C(i,j) = g(i + j)
  * Staircase scheduling (SS, paper eq. 29): C(i,j) = g(i + (-1)^i * j)
  * Random assignment   (RA, [18]):          each row an independent random
    permutation of [n] (requires r == n)
  * round-robin block / custom matrices via validation helpers.

The greedy and adaptive row assignment waits for the port's adaptive slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

__all__ = [
    "MASKED",
    "cyclic_to_matrix",
    "staircase_to_matrix",
    "random_assignment_to_matrix",
    "block_to_matrix",
    "validate_to_matrix",
    "loads_of_matrix",
    "mask_matrix_loads",
    "to_matrix",
    "SCHEDULES",
    "Schedule",
]

MASKED = -1      # sentinel task index for the inactive trailing slots of a
                 # ragged row (worker load < grid width)


def _g(m: np.ndarray, n: int) -> np.ndarray:
    """Paper's wrap-around map g (eq. 22), 0-indexed: fold into [0, n)."""
    return np.mod(m, n)


def _check_loads(n: int, loads, r: int | None) -> tuple[np.ndarray, int]:
    """Validate a per-worker load vector against ``n`` workers and an
    optional grid width ``r`` (defaults to ``max(loads)``).  Returns
    ``(loads, r_max)``."""
    lv = np.asarray(loads, np.int64)
    if lv.shape != (n,):
        raise ValueError(f"loads must have shape ({n},), got {lv.shape}")
    if lv.min() < 1:
        raise ValueError(f"every worker needs load >= 1, got min {lv.min()}")
    r_max = int(lv.max()) if r is None else int(r)
    if lv.max() > r_max:
        raise ValueError(f"max load {lv.max()} exceeds grid width r={r_max}")
    if not 1 <= r_max <= n:
        raise ValueError(f"need 1 <= r <= n, got r={r_max}, n={n}")
    return lv, r_max


def mask_matrix_loads(C: np.ndarray, loads) -> np.ndarray:
    """Apply a load vector to a dense TO matrix: slots ``j >= loads[i]`` of
    row ``i`` are replaced with the ``MASKED`` sentinel."""
    C = np.asarray(C).astype(np.int64).copy()
    lv, _ = _check_loads(C.shape[0], loads, C.shape[1])
    C[np.arange(C.shape[1])[None, :] >= lv[:, None]] = MASKED
    return C


def cyclic_to_matrix(n: int, r: int | None = None, *,
                     loads=None) -> np.ndarray:
    """CS schedule (eq. 21): every worker walks the ring in the same
    direction, offset by its index, so each task has the same execution
    *position* at every worker that holds it.  With ``loads``, row ``i``
    keeps only its first ``loads[i]`` slots (trailing slots ``MASKED``);
    the slot-0 diagonal ``C[i, 0] = i`` keeps every task covered for any
    load vector."""
    if loads is not None:
        _, r = _check_loads(n, loads, r)
    elif r is None:
        raise ValueError("need a load r (or a loads vector)")
    if not (1 <= r <= n):
        raise ValueError(f"need 1 <= r <= n, got r={r}, n={n}")
    i = np.arange(n)[:, None]
    j = np.arange(r)[None, :]
    C = _g(i + j, n).astype(np.int64)
    return C if loads is None else mask_matrix_loads(C, loads)


def staircase_to_matrix(n: int, r: int | None = None, *,
                        loads=None) -> np.ndarray:
    """SS schedule (eq. 29): even-indexed workers walk the ring ascending,
    odd-indexed workers descending (0-indexed parity matches the paper's
    1-indexed convention: paper worker 1 ≙ row 0 ascends).  ``loads`` masks
    each row's trailing slots as in ``cyclic_to_matrix``; the slot-0
    diagonal again guarantees coverage."""
    if loads is not None:
        _, r = _check_loads(n, loads, r)
    elif r is None:
        raise ValueError("need a load r (or a loads vector)")
    if not (1 <= r <= n):
        raise ValueError(f"need 1 <= r <= n, got r={r}, n={n}")
    i = np.arange(n)[:, None]
    j = np.arange(r)[None, :]
    sign = np.where(i % 2 == 0, 1, -1)
    C = _g(i + sign * j, n).astype(np.int64)
    return C if loads is None else mask_matrix_loads(C, loads)


def random_assignment_to_matrix(n: int, r: int | None = None, *,
                                rng: np.random.Generator | None = None,
                                seed: int | None = 0,
                                loads=None) -> np.ndarray:
    """RA scheme [18]: r = n (full dataset at each worker); each row is an
    independent uniformly random permutation of [n].  With ``loads``, row
    ``i`` starts at its own task ``i`` (restoring the coverage guarantee a
    truncated random permutation would lose) followed by a random
    permutation of the rest, truncated to ``loads[i]`` slots."""
    if loads is not None:
        lv, r_max = _check_loads(n, loads, r if r is not None else n)
        if rng is None:
            rng = np.random.default_rng(seed)
        C = np.full((n, r_max), MASKED, np.int64)
        for i in range(n):
            rest = rng.permutation(np.delete(np.arange(n), i))
            row = np.concatenate([[i], rest])
            C[i, :lv[i]] = row[:lv[i]]
        return C
    if r is not None and r != n:
        raise ValueError(f"RA requires r == n (got r={r}, n={n})")
    if rng is None:
        rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(n) for _ in range(n)]).astype(np.int64)


def block_to_matrix(n: int, r: int | None = None, *,
                    loads=None) -> np.ndarray:
    """Naive blocked redundancy baseline (not in the paper; useful ablation):
    worker i computes tasks {i, i+1, ..., i+r-1} like CS but all workers
    start from the *lowest* index of their block — i.e. identical to CS.
    Differs for the ablation where workers share a start: C(i,j) = g(⌊i/r⌋*r + j).
    ``loads`` masks trailing slots (note: unlike CS/SS, blocked rows have no
    slot-0 diagonal, so ragged blocks may leave tasks uncovered).
    """
    if loads is not None:
        _, r = _check_loads(n, loads, r)
    elif r is None:
        raise ValueError("need a load r (or a loads vector)")
    if not (1 <= r <= n):
        raise ValueError(f"need 1 <= r <= n, got r={r}, n={n}")
    i = np.arange(n)[:, None]
    j = np.arange(r)[None, :]
    C = _g((i // max(r, 1)) * r + j, n).astype(np.int64)
    return C if loads is None else mask_matrix_loads(C, loads)


def loads_of_matrix(C: np.ndarray) -> np.ndarray:
    """Per-worker load vector of a (possibly ragged) TO matrix: the number
    of active (non-``MASKED``) leading slots of each row.  Raises if a
    ``MASKED`` sentinel appears before an active slot (masks must be a
    trailing suffix) or a row is fully masked."""
    C = np.asarray(C)
    if C.ndim != 2:
        raise ValueError(f"TO matrix must be 2-D, got shape {C.shape}")
    active = C != MASKED
    loads = active.sum(axis=1).astype(np.int64)
    if loads.min() < 1:
        raise ValueError(f"row {int(loads.argmin())} has no active slots")
    # masks must be contiguous and trailing: row i active exactly at j < l_i
    expect = np.arange(C.shape[1])[None, :] < loads[:, None]
    if not np.array_equal(active, expect):
        bad = int(np.nonzero((active != expect).any(axis=1))[0][0])
        raise ValueError(f"row {bad} has a MASKED sentinel before an active "
                         f"slot; masks must be a trailing suffix: {C[bad]}")
    return loads


def validate_to_matrix(C: np.ndarray, n: int | None = None,
                       require_distinct: bool = True,
                       loads=None) -> None:
    """Check C is a valid TO matrix: shape (n, r), active entries in
    [0, n), optionally distinct within each row's active prefix (any
    optimal C has distinct rows, paper Sec. II).  Rows may be ragged:
    trailing slots holding the ``MASKED`` sentinel are inactive; ``loads``
    (optional) cross-checks the per-row active counts."""
    C = np.asarray(C)
    if C.ndim != 2:
        raise ValueError(f"TO matrix must be 2-D, got shape {C.shape}")
    n_ = C.shape[0] if n is None else n
    if n is not None and C.shape[0] != n:
        raise ValueError(f"TO matrix has {C.shape[0]} rows, expected n={n}")
    if C.shape[1] > n_:
        raise ValueError(f"computation load r={C.shape[1]} exceeds n={n_}")
    lv = loads_of_matrix(C)                # also checks trailing-mask shape
    if loads is not None:
        want, _ = _check_loads(C.shape[0], loads, C.shape[1])
        if not np.array_equal(lv, want):
            raise ValueError(f"matrix loads {lv.tolist()} do not match the "
                             f"given loads {want.tolist()}")
    act = C[C != MASKED]
    if act.min() < 0 or act.max() >= n_:
        raise ValueError(f"task indices must lie in [0, {n_}), got "
                         f"[{act.min()}, {act.max()}]")
    if require_distinct:
        for i, row in enumerate(C):
            row = row[:lv[i]]
            if len(set(row.tolist())) != len(row):
                raise ValueError(f"row {i} has repeated tasks: {row}")


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A named TO-matrix construction."""
    name: str
    build: Callable[..., np.ndarray]

    def __call__(self, n: int, r: int | None = None, **kw) -> np.ndarray:
        # ``r`` is passed through for every schedule — RA's constructor rejects
        # r != n rather than silently ignoring the requested load.
        C = self.build(n, r, **kw)
        validate_to_matrix(C, n, loads=kw.get("loads"))
        return C


SCHEDULES: dict[str, Schedule] = {
    "cs": Schedule("cs", cyclic_to_matrix),
    "ss": Schedule("ss", staircase_to_matrix),
    "ra": Schedule("ra", random_assignment_to_matrix),
    "block": Schedule("block", block_to_matrix),
}


def to_matrix(name: str, n: int, r: int | None = None, **kw) -> np.ndarray:
    """Build a named TO matrix (``cs`` | ``ss`` | ``ra`` | ``block``).
    ``loads=`` builds the ragged variant (per-worker loads, trailing slots
    ``MASKED``) for every schedule that supports it."""
    try:
        sched = SCHEDULES[name.lower()]
    except KeyError:
        raise ValueError(f"unknown schedule {name!r}; have {sorted(SCHEDULES)}")
    return sched(n, r, **kw)
