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

Adaptive row assignment: ``greedy_row_assignment`` re-permutes the rows of
a base TO matrix from per-worker delay feedback (fastest workers pick
first, each taking the row that covers the least-covered tasks);
``greedy_row_assignment_batch`` is its batched torch form, whose pick loop
is the ``greedy_assign`` kernel on the card and its plain version on the
CPU; ``censored_feedback_update`` is the censored feedback rule shared by
``AdaptiveScheduler`` and the rounds engine.

Load re-balancing: ``greedy_load_rebalance`` re-allocates whole slots
between workers from the same delay estimates under a fixed total budget
(makespan descent); ``greedy_load_rebalance_batch`` is its batched torch
form (a Python loop of single-slot moves on (B, n) tensors), used every
round by the rounds engine and by ``AdaptiveScheduler(rebalance=True)``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device

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
    "GREEDY_IMPLS",
    "greedy_row_assignment",
    "greedy_row_assignment_batch",
    "greedy_load_rebalance",
    "greedy_load_rebalance_batch",
    "censored_feedback_update",
    "AdaptiveScheduler",
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


# --------------------- adaptive row assignment -------------------------------

def greedy_row_assignment(C: np.ndarray, speed_est=None, *,
                          gamma: float = 0.5, need=None,
                          device=None) -> np.ndarray:
    """Assign workers to the rows of base TO matrix ``C`` from estimated
    per-worker delays: fastest workers pick first, each taking the row whose
    leading slots cover the least-covered tasks (slot j of a chosen row adds
    ``gamma**j / speed_est[w]`` coverage to its task).  ``speed_est`` None
    means no feedback yet (uniform speeds).  ``need`` (length-n bool over
    tasks) puts rows holding a needed task first (reissue).

    Returns ``worker_of_row`` (int64): worker ``worker_of_row[p]`` executes
    row ``p``.  Runs ``greedy_row_assignment_batch`` on ``device`` (the
    card by default, where the pick loop is the ``greedy_assign``
    kernel)."""
    C = np.asarray(C)
    n, r = C.shape
    est = (np.ones(n, np.float32) if speed_est is None
           else np.asarray(speed_est, np.float32))
    if est.shape != (n,):
        raise ValueError(f"speed_est must have shape ({n},), got {est.shape}")
    dev = resolve_device(device)
    nd = None
    if need is not None:
        nd = np.asarray(need)
        if nd.shape != (n,):
            raise ValueError(f"need must have shape ({n},), got {nd.shape}")
        nd = torch.as_tensor(nd.astype(np.float32), device=dev)[None]
    out = greedy_row_assignment_batch(
        C, torch.as_tensor(est, device=dev)[None], gamma=gamma, need=nd)
    return out[0].cpu().numpy().astype(np.int64)


GREEDY_IMPLS = ("auto", "scan", "kernel")


def _resolve_greedy_impl(impl: str | None) -> str:
    """``None``/``"auto"``/``"kernel"`` -> the kernel's wrapper, which runs
    the CUDA kernel for tensors on the card and the plain version for CPU
    tensors; ``"scan"`` -> the plain version on any device (tests)."""
    if impl in (None, "auto"):
        return "kernel"
    if impl not in ("scan", "kernel"):
        raise ValueError(f"unknown greedy impl {impl!r}; choose from "
                         f"{GREEDY_IMPLS}")
    return impl


@functools.lru_cache(maxsize=None)
def _greedy_matrices(C_tup: tuple, gamma: float):
    """Static pick-loop matrices of a TO matrix: the coverage weights
    ``W[p, t] = sum_j gamma**j * [C[p, j] == t]`` (active slots only) and
    the 0/1 row-covers-task incidence ``A[p, t]``, float32 numpy, exactly
    the JAX package's."""
    C = np.asarray(C_tup)
    n, r = C.shape
    active = C != MASKED
    disc = gamma ** np.arange(r)
    W = np.zeros((n, n), np.float32)
    A = np.zeros((n, n), np.float32)
    for p in range(n):
        for j in range(r):
            if active[p, j]:
                W[p, C[p, j]] += np.float32(disc[j])
                A[p, C[p, j]] = 1.0
    return W, A


@functools.lru_cache(maxsize=64)
def _greedy_tensors(C_tup: tuple, gamma: float, device: torch.device):
    W, A = _greedy_matrices(C_tup, gamma)
    return (torch.as_tensor(W, device=device),
            torch.as_tensor(A > 0, device=device))


def greedy_row_assignment_batch(C: np.ndarray, est: torch.Tensor, *,
                                gamma: float = 0.5,
                                need: torch.Tensor | None = None,
                                impl: str | None = None) -> torch.Tensor:
    """Batched twin of ``greedy_row_assignment`` on ``est``'s device:
    ``est`` (..., n) -> ``worker_of_row`` (..., n) int32.  ``C`` may be
    ragged (``MASKED`` slots add no coverage).  ``need`` ((..., n) or (n,)
    over tasks, nonzero = needed) is the reissue priority.

    As in the JAX package: the pickers are a *stable* argsort of ``est``
    (ties in ``est`` are the rule: all-ones before feedback, +inf for
    never-observed workers), ``epick = max(est, 1e-30)`` in float32, and
    the reissue row priority is the count ``(need > 0) @ A.T``, computed
    here as an exact integer sum.  ``impl`` picks the pick loop (see
    ``_resolve_greedy_impl``)."""
    from ..kernels import ops as kernel_ops
    from ..kernels.ref import greedy_assign_ref
    C = np.asarray(C)
    n = C.shape[0]
    C_tup = tuple(tuple(int(v) for v in row) for row in C)
    W, A = _greedy_tensors(C_tup, float(gamma), est.device)
    batch = est.shape[:-1]
    flat = est.reshape(-1, n).to(torch.float32)
    order = torch.argsort(flat, dim=-1, stable=True)
    epick = torch.clamp(torch.take_along_dim(flat, order, dim=-1), min=1e-30)
    need_row = None
    if need is not None:
        nd = torch.broadcast_to(need.to(est.device), est.shape)
        nd = (nd.reshape(-1, n) > 0)
        need_row = (nd[:, None, :] & A[None]).sum(-1).to(torch.float32)
    if _resolve_greedy_impl(impl) == "kernel":
        out = kernel_ops.greedy_assign(W, order, epick, need_row)
    else:
        out = greedy_assign_ref(W, order, epick, need_row)
    return out.reshape(batch + (n,))


def greedy_load_rebalance(speed_est, loads=None, *, total: int | None = None,
                          r_max: int, min_load: int = 1,
                          steps: int | None = None,
                          device=None) -> np.ndarray:
    """Re-allocate whole computation slots between workers from estimated
    per-task delays under a fixed total budget (Egger et al.,
    arXiv:2304.08589).  Starting from ``loads`` (or an as-even-as-possible
    split of ``total``), one slot at a time moves from the worker with the
    largest estimated finish ``est[w] * loads[w]`` to the worker whose
    post-move finish ``est[w'] * (loads[w'] + 1)`` is smallest, while that
    strictly lowers the donor's finish; ``min_load <= loads[w] <= r_max``
    and ``sum(loads)`` stay fixed.  ``+inf`` estimates (never observed)
    shed slots down to ``min_load``; all-``inf`` or equal estimates on a
    uniform split leave it unchanged.

    Returns the new per-worker loads (int64).  Runs
    ``greedy_load_rebalance_batch`` on ``device`` (the card by default)."""
    if loads is None:
        if total is None or speed_est is None:
            raise ValueError("need an initial loads vector, or a total "
                             "budget plus a speed_est to size it from")
        n = np.asarray(speed_est).shape[0]
        base, extra = divmod(int(total), n)
        lv = np.full(n, base, np.int64)
        lv[:extra] += 1                    # as-even-as-possible split
    else:
        lv = np.asarray(loads, np.int64)
    n = lv.shape[0]
    if total is not None and int(lv.sum()) != int(total):
        raise ValueError(f"loads sum {lv.sum()} != total budget {total}")
    if not 1 <= min_load <= lv.min():
        raise ValueError(f"need 1 <= min_load <= min(loads); got "
                         f"min_load={min_load}, loads min {lv.min()}")
    if lv.max() > r_max:
        raise ValueError(f"max load {lv.max()} exceeds r_max={r_max}")
    est = (np.ones(n, np.float32) if speed_est is None
           else np.asarray(speed_est, np.float32))
    if est.shape != (n,):
        raise ValueError(f"speed_est must have shape ({n},), got {est.shape}")
    out = greedy_load_rebalance_batch(
        torch.as_tensor(est, device=resolve_device(device))[None], lv,
        r_max=int(r_max), min_load=int(min_load), steps=steps)
    return out[0].cpu().numpy().astype(np.int64)


def greedy_load_rebalance_batch(est: torch.Tensor, loads, *, r_max: int,
                                min_load: int = 1,
                                steps: int | None = None) -> torch.Tensor:
    """Batched twin of ``greedy_load_rebalance`` on ``est``'s device:
    ``est`` (..., n) float32 (+inf = never observed), ``loads`` the initial
    allocation (n,) -> per-worker loads (..., n) int32, each summing to
    ``sum(loads)``.  ``steps`` single-slot moves (default ``n * r_max``,
    enough to reach the fixed point; further moves are no-ops).

    Each move, as in the JAX package: ``finish = est * l``; ``give`` is
    ``finish``, or -inf where ``l <= min_load``; ``take`` is ``est * (l +
    1)``, or +inf where ``l >= r_max``; the donor is the first argmax of
    ``give``, the receiver the first argmin of ``take``, and the slot moves
    only if ``give[d] > take[w]`` and ``d != w``.  Every step is an exact
    float32 product, a comparison or an integer add, so the result equals
    the JAX package's bit for bit."""
    lv = np.asarray(loads, np.int64)
    n = lv.shape[0]
    if steps is None:
        steps = int(n * r_max)
    dev = est.device
    batch = est.shape[:-1]
    e = est.reshape(-1, n).to(torch.float32)
    l = torch.as_tensor(lv, dtype=torch.int32, device=dev).expand(
        e.shape[0], n).contiguous()
    ninf = torch.tensor(-np.inf, dtype=torch.float32, device=dev)
    pinf = torch.tensor(np.inf, dtype=torch.float32, device=dev)
    for _ in range(steps):
        lf = l.to(torch.float32)
        give = torch.where(l > min_load, e * lf, ninf)
        take = torch.where(l < r_max, e * (lf + 1.0), pinf)
        # first index on ties, as JAX's argmax / argmin
        give_d, d = torch.max(give, dim=-1, keepdim=True)  # slowest finish
        take_w, w = torch.min(take, dim=-1, keepdim=True)  # cheapest slot
        # `inf > inf` is False: an all-inf / no-feedback round keeps the
        # split; a donor at min_load gives -inf, a full receiver takes +inf
        ok = ((give_d > take_w) & (d != w)).to(torch.int32)
        l = l.scatter_add(-1, w, ok).scatter_add(-1, d, -ok)
    return l.reshape(batch + (n,))


def _left_fold_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as an explicit left fold (the same bits on
    every device and for any thread count)."""
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def censored_feedback_update(est: torch.Tensor, t1: torch.Tensor,
                             arrivals: torch.Tensor, t_done, *,
                             beta: float = 0.7) -> torch.Tensor:
    """One censored-feedback step, shared by ``AdaptiveScheduler.observe``
    and the rounds engine (``sweep_rounds(..., censored_feedback=True)``).

    ``est`` (..., n) holds per-worker delay estimates (+inf = never yet
    observed); ``t1``/``arrivals`` (..., n, r) the round's per-slot compute
    delays and per-message arrival times, worker-major; ``t_done`` (scalar
    or (...,)) the round's completion.  Only slots whose message arrived by
    ``t_done`` (and finitely) are observed: an observed worker gets its
    masked-mean compute delay (replacing +inf on first observation, an EMA
    with weight ``beta`` on history after), a silent worker keeps its
    estimate.  The masked sum is a left fold over the slots (the JAX
    package's ``sum`` is XLA's); float32 throughout."""
    dev = est.device
    t1 = torch.as_tensor(t1, dtype=torch.float32, device=dev)
    arr = torch.as_tensor(arrivals, dtype=torch.float32, device=dev)
    td = torch.as_tensor(t_done, dtype=torch.float32, device=dev)
    td = td[..., None, None]
    mobs = (arr <= td) & torch.isfinite(arr)
    cnt = mobs.sum(dim=-1)
    total = _left_fold_sum(torch.where(mobs, t1, 0.0))
    obs = torch.where(cnt > 0,
                      total / torch.clamp(cnt, min=1).to(torch.float32), 0.0)
    seen = torch.isfinite(est)
    upd = torch.where(seen, beta * est + (1.0 - beta) * obs, obs)
    return torch.where(cnt > 0, upd, est)


class AdaptiveScheduler:
    """Stateful round-to-round re-permutation of a base TO matrix (host
    numpy state, as in the JAX package).

    Call ``matrix()`` before each round for the effective schedule and
    ``observe(t1)`` after it with the round's per-worker compute delays
    ((n,) means or the raw (n, r) slot delays).  Feedback is an EMA with
    weight ``beta`` on history.  ``observe(t1, arrivals=, t_done=)``
    censors it to the slots whose message reached the master by the round's
    close; a worker never yet observed sits at +inf (ranked slowest).

    ``dead_after``: a worker silent for that many consecutive observed
    rounds is presumed dead (estimate forced to +inf); with ``target_k``,
    ``matrix()`` raises when the surviving assignment covers fewer than
    ``target_k`` distinct tasks.  ``set_need`` marks tasks to re-gather
    first next round.

    ``rebalance``: ``C`` is a dense base whose width is the per-worker load
    cap and ``loads`` the initial budget; each round's loads are
    re-balanced from the same (dead-censored) estimates by
    ``greedy_load_rebalance`` (``loads()``), and ``matrix()`` masks the
    effective schedule to them.  The greedy assignment and the re-balance
    run on ``device`` (the card by default: the ``greedy_assign``
    kernel)."""

    def __init__(self, C: np.ndarray, *, beta: float = 0.7,
                 gamma: float = 0.5, loads=None, rebalance: bool = False,
                 min_load: int = 1, dead_after: int | None = None,
                 target_k: int | None = None, device=None):
        self.C = np.asarray(C)
        self.rebalance = bool(rebalance)
        if self.rebalance:
            if (self.C == MASKED).any():
                raise ValueError("rebalance needs a dense base matrix (its "
                                 "width is the per-worker load cap); pass "
                                 "the budget via loads=")
            validate_to_matrix(self.C)
            if loads is None:
                raise ValueError("rebalance needs an initial loads budget "
                                 "below the grid width (loads=)")
            self.base_loads, _ = _check_loads(self.C.shape[0], loads,
                                              self.C.shape[1])
        else:
            validate_to_matrix(self.C, loads=loads)
            self.base_loads = loads_of_matrix(self.C)
        self.min_load = int(min_load)
        self.beta = float(beta)
        self.gamma = float(gamma)
        if dead_after is not None and dead_after < 1:
            raise ValueError(f"dead_after must be >= 1, got {dead_after}")
        if target_k is not None and not 1 <= target_k <= self.C.shape[0]:
            raise ValueError(f"target_k must be in [1, {self.C.shape[0]}], "
                             f"got {target_k}")
        self.dead_after = dead_after
        self.target_k = target_k
        self.device = resolve_device(device)
        self.est: np.ndarray | None = None
        self.silent = np.zeros(self.C.shape[0], np.int64)
        self._need: np.ndarray | None = None
        self._assignment: np.ndarray | None = None   # valid until observe()
        self._loads: np.ndarray | None = None

    def dead_workers(self) -> np.ndarray:
        """Bool (n,): workers presumed dead (all False without
        ``dead_after``)."""
        if self.dead_after is None:
            return np.zeros(self.C.shape[0], bool)
        return self.silent >= self.dead_after

    def _effective_est(self) -> np.ndarray | None:
        """Feedback estimates with presumed-dead workers at +inf."""
        dead = self.dead_workers()
        if not dead.any():
            return self.est
        base = (np.ones(self.C.shape[0], np.float64) if self.est is None
                else self.est)
        return np.where(dead, np.inf, base)

    def set_need(self, need) -> None:
        """Mark tasks to re-gather first next round: a length-n bool over
        tasks (or None to clear)."""
        nd = None if need is None else np.asarray(need, bool)
        if nd is not None and nd.shape != (self.C.shape[0],):
            raise ValueError(f"need must have shape ({self.C.shape[0]},), "
                             f"got {nd.shape}")
        self._need = nd if nd is not None and nd.any() else None
        self._assignment = None

    def worker_of_row(self) -> np.ndarray:
        if self._assignment is None:
            self._assignment = greedy_row_assignment(
                self.C, self._effective_est(), gamma=self.gamma,
                need=self._need, device=self.device)
        return self._assignment

    def row_of_worker(self) -> np.ndarray:
        w_of_row = self.worker_of_row()
        inv = np.empty_like(w_of_row)
        inv[w_of_row] = np.arange(len(w_of_row))
        return inv

    def loads(self) -> np.ndarray:
        """Per-worker loads for the coming round: the assigned rows' own
        loads, re-balanced from feedback under ``rebalance`` (workers with
        no estimate yet count as slowest, +inf)."""
        if not self.rebalance:
            return self.base_loads[self.row_of_worker()]
        if self._loads is None:
            est = self._effective_est()
            if est is None:
                est = np.full(self.C.shape[0], np.inf)
            self._loads = greedy_load_rebalance(
                est, self.base_loads, r_max=self.C.shape[1],
                min_load=self.min_load, device=self.device)
        return self._loads

    def matrix(self) -> np.ndarray:
        """The effective TO matrix for the coming round (row ``w`` is what
        worker ``w`` executes, ``MASKED`` beyond its load).  With
        ``dead_after`` + ``target_k``, raises when the rows held by
        surviving workers cover fewer than ``target_k`` distinct tasks."""
        M = self.C[self.row_of_worker()]
        if self.rebalance:
            M = mask_matrix_loads(M, self.loads())
        dead = self.dead_workers()
        if self.target_k is not None and dead.any():
            alive_rows = M[~dead]
            act = alive_rows[alive_rows != MASKED]
            covered = int(np.unique(act).size)
            if covered < self.target_k:
                raise ValueError(
                    f"graceful degradation impossible: {int(dead.sum())} of "
                    f"{self.C.shape[0]} workers presumed dead (no delivery "
                    f"for {self.dead_after} consecutive rounds) and the "
                    f"surviving assignment covers only {covered} distinct "
                    f"tasks < k={self.target_k}; lower k, raise the "
                    f"per-worker load, or raise dead_after")
        return M

    def observe(self, t1, *, arrivals=None, t_done=None) -> None:
        n = self.C.shape[0]
        obs = np.asarray(t1, np.float64)
        if (arrivals is None) != (t_done is None):
            raise ValueError("censored feedback needs BOTH arrivals and "
                             "t_done (or neither)")
        if arrivals is not None:
            arr = np.asarray(arrivals, np.float64)
            if obs.ndim != 2 or obs.shape[0] != n or arr.shape != obs.shape:
                raise ValueError(
                    f"censored feedback needs per-slot (n={n}, r) compute "
                    f"delays and matching arrivals; got {obs.shape} and "
                    f"{arr.shape}")
            est = (np.full(n, np.inf) if self.est is None else self.est)
            new = censored_feedback_update(
                torch.as_tensor(est, dtype=torch.float32), obs, arr,
                float(t_done), beta=self.beta)
            self.est = new.numpy().astype(np.float64)
            delivered = (np.isfinite(arr) & (arr <= float(t_done))).any(-1)
            self.silent = np.where(delivered, 0, self.silent + 1)
            self._assignment = None
            self._loads = None
            return
        if obs.ndim == 2:
            # +inf slot delays must not drag the row mean to inf: average
            # the finite slots only
            fin = np.isfinite(obs)
            cnt = fin.sum(-1)
            obs = np.where(cnt > 0,
                           np.where(fin, obs, 0.0).sum(-1)
                           / np.maximum(cnt, 1), np.inf)
        if obs.shape != (n,):
            raise ValueError(f"feedback must be (n,) or (n, r) for "
                             f"n={n}; got {obs.shape}")
        delivered = np.isfinite(obs)
        if self.est is None:
            self.est = np.where(delivered, obs, np.inf)
        else:
            seen = np.isfinite(self.est)
            upd = np.where(seen,
                           self.beta * self.est + (1.0 - self.beta) * obs,
                           obs)
            self.est = np.where(delivered, upd, self.est)
        self.silent = np.where(delivered, 0, self.silent + 1)
        self._assignment = None
        self._loads = None
