"""Arrival-time / completion-time computation (paper eqs. 1-6, 46) over a
leading ``trials`` axis; counterpart of ``repro.core.completion``.

Conventions: ``C`` is a TO matrix (n, r) with task indices in [0, n) or
``MASKED`` (-1); ``T1``/``T2`` are per-slot computation / communication
delays (trials, n, r).

* slot arrival   ``s[t,i,j] = sum_{m<=j} T1[t,i,m] + T2[t,i,j]``   (eq. 1)
* task arrival   ``tau[t,p] = min over slots with C[i,j]==p``      (eq. 2)
* completion     ``t_C(r,k) = k-th smallest of tau``                (eq. 6)
* oracle LB      ``k-th smallest of all n*r slot arrivals``         (eq. 46)

``message_arrival_times`` generalizes eq. (1) to an intra-round message
budget (paper Sec. V-C).  Every function here is exact given its inputs
(gathers, mins, sorts, elementwise float32 adds): on the same tables it
returns what the JAX package returns, bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import montecarlo
from .montecarlo import INF, slot_arrival_times

__all__ = [
    "slot_arrival_times", "message_arrival_times", "message_slot_layout",
    "row_layout_is_identity", "apply_row_layout", "task_arrival_times",
    "completion_time", "lower_bound_time", "first_k_distinct_mask",
    "winner_mask_gather", "simulate_completion", "simulate_lower_bound",
    "mean_completion_time",
]


def message_slot_layout(loads, r: int, messages: int,
                        comm_eps: float = 0.0):
    """Static per-row message layout for a (possibly ragged) slot grid:
    ``(smap, offsets, active)`` — the (n, r) closing-slot remap, per-slot
    overhead offsets (None when ``comm_eps`` is 0) and active-slot mask
    (None when dense)."""
    lv = np.asarray(loads, np.int64)
    n = lv.shape[0]
    smap = np.broadcast_to(np.arange(r), (n, r)).copy()
    off = np.zeros((n, r), np.float32)
    active = np.zeros((n, r), bool)
    for i, l in enumerate(lv):
        mi = min(int(messages), int(l))
        smap[i, :l] = montecarlo.message_slot_map(int(l), mi)
        b = montecarlo.message_boundaries(int(l), mi)
        off[i, :l] = comm_eps * (np.searchsorted(b, np.arange(int(l))) + 1)
        active[i, :l] = True
    return (smap, off if comm_eps else None,
            None if active.all() else active)


def row_layout_is_identity(layout) -> bool:
    """True when a ``message_slot_layout`` result is a no-op (dense,
    per-slot sends, no overhead)."""
    smap, off, act = layout
    n, r = smap.shape
    return (off is None and act is None
            and np.array_equal(smap, np.broadcast_to(np.arange(r), (n, r))))


def apply_row_layout(s: torch.Tensor, layout) -> torch.Tensor:
    """Apply a static per-row message layout to per-slot arrivals ``s``
    (..., n, r): closing-slot remap, overhead offsets, +inf beyond each
    row's load."""
    smap, off, act = layout
    idx = torch.as_tensor(smap, dtype=torch.int64, device=s.device)
    out = torch.take_along_dim(s, idx.expand(s.shape), dim=-1)
    if off is not None:
        out = out + torch.as_tensor(off, device=s.device)
    if act is not None:
        out = torch.where(torch.as_tensor(act, device=s.device), out, INF)
    return out


def message_arrival_times(T1: torch.Tensor, T2: torch.Tensor, messages: int,
                          *, loads=None, comm_eps: float = 0.0
                          ) -> torch.Tensor:
    """Generalized eq. (1) for an intra-round message budget: slot ``j``'s
    result arrives when its message closes.  ``messages == r`` is eq. (1);
    ``loads`` makes the grouping per worker (masked slots come out +inf);
    ``comm_eps`` lands a worker's l-th message ``(l + 1) * comm_eps``
    late."""
    r = T1.shape[-1]
    n = T1.shape[-2]
    s = slot_arrival_times(T1, T2)
    if loads is None and not comm_eps:
        if int(messages) == r:
            return s
        idx = torch.as_tensor(montecarlo.message_slot_map(r, messages),
                              device=s.device)
        return s[..., idx]
    lv = (np.full(n, r, np.int64) if loads is None
          else np.asarray(loads, np.int64))
    return apply_row_layout(s, message_slot_layout(lv, r, messages,
                                                   comm_eps))


def _active_of(C) -> Optional[np.ndarray]:
    """Active-slot mask of a (possibly ragged) TO matrix, or None when all
    slots are active."""
    active = np.asarray(C) >= 0
    return None if active.all() else active


def task_arrival_times(C, s: torch.Tensor, n: int) -> torch.Tensor:
    """eq. (2) by scatter-min: per-task earliest arrival across all (worker,
    slot) holding the task; tasks never assigned get +inf.  C (n_w, r), s
    (..., n_w, r) -> (..., n); ``MASKED`` slots are excluded."""
    active = _active_of(C)
    if active is not None:
        s = torch.where(torch.as_tensor(active, device=s.device), s, INF)
    Cf = torch.as_tensor(np.asarray(C), dtype=torch.int64,
                         device=s.device).reshape(-1).clamp(min=0)
    sf = s.reshape(s.shape[:-2] + (-1,))
    init = sf.new_full(sf.shape[:-1] + (n,), INF)
    return init.scatter_reduce(-1, Cf.expand(sf.shape), sf, reduce="amin",
                               include_self=True)


def completion_time(tau: torch.Tensor, k: int) -> torch.Tensor:
    """eq. (6): the k-th order statistic of task arrivals."""
    return torch.sort(tau, dim=-1).values[..., k - 1]


def lower_bound_time(s: torch.Tensor, k: int) -> torch.Tensor:
    """eq. (46): the k-th order statistic over ALL slot arrivals."""
    sf = s.reshape(s.shape[:-2] + (-1,))
    return torch.sort(sf, dim=-1).values[..., k - 1]


def first_k_distinct_mask(C, s: torch.Tensor, n: int, k: int, *,
                          deadline: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Which (worker, slot) results the master uses: the earliest copy of
    each of the k earliest-arriving distinct tasks.  Returns ``(weights,
    t_done)``: per-slot weights (..., n_w, r) — winners of a selected task
    share weight 1 — and the completion time (...,).  ``deadline`` closes
    the round at ``min(t_done, deadline)``."""
    tau = task_arrival_times(C, s, n)
    return _winner_weights(C, s, tau, k, _active_of(C), deadline=deadline)


def winner_mask_gather(C, plan, s: torch.Tensor, n: int, k: int, *,
                       deadline: Optional[float] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``first_k_distinct_mask`` with task arrivals through the engine's
    static gather plan (``task_gather_plan(C, n)``)."""
    tau = montecarlo.task_arrival_times_gather(plan, s)
    return _winner_weights(C, s, tau, k, _active_of(C), deadline=deadline)


def _winner_weights(C, s: torch.Tensor, tau: torch.Tensor, k: int,
                    active: Optional[np.ndarray], *,
                    deadline: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    t_done = completion_time(tau, k)
    if deadline is not None:
        t_done = torch.clamp(t_done, max=float(deadline))
    # +inf-safe: a censored task must not be "selected" when t_done is
    # itself +inf
    selected = (tau <= t_done[..., None]) & torch.isfinite(tau)
    # a MASKED slot's -1 reads task n-1 here, as in the JAX package; the
    # active mask below bars it from winning
    Ct = torch.as_tensor(np.asarray(C), dtype=torch.int64, device=s.device)
    Ct = torch.where(Ct < 0, Ct + tau.shape[-1], Ct)
    tau_at_slot = tau[..., Ct]                           # (..., n_w, r)
    sel_at_slot = selected[..., Ct]
    is_winner = (s <= tau_at_slot) & sel_at_slot
    if active is not None:
        is_winner = is_winner & torch.as_tensor(active, device=s.device)
    # normalize per task so duplicated winners (measure-zero ties) average;
    # the counts are small integers, exact in any summation order
    ones = is_winner.to(s.dtype)
    per_task_count = torch.zeros_like(tau).index_add_(
        -1, Ct.reshape(-1), ones.reshape(ones.shape[:-2] + (-1,)))
    cnt_at_slot = torch.clamp(per_task_count[..., Ct], min=1.0)
    return ones / cnt_at_slot, t_done


# ---------------- Monte-Carlo drivers ----------------------------------------
# Thin wrappers over the sweep engine (see montecarlo.py), on ``devices``
# (the card by default; ``"cpu"`` to run on the CPU).

def simulate_completion(C, model, k: int, *, trials: int = 10000,
                        seed: int = 0, chunk: Optional[int] = None,
                        devices=None) -> torch.Tensor:
    """Sample ``trials`` rounds of the schedule ``C`` under ``model`` and
    return the completion-time samples, shape (trials,).  ``C`` may be
    ragged (trailing ``MASKED`` sentinels)."""
    n = np.asarray(C).shape[0]
    return montecarlo.completion_samples(
        montecarlo.to_spec("to", C), model, n, trials=trials, seed=seed,
        chunk=chunk, k=k, devices=devices)


def simulate_lower_bound(model, n: int, r: Optional[int] = None,
                         k: int = 1, *, trials: int = 10000,
                         seed: int = 0, chunk: Optional[int] = None,
                         loads=None, devices=None) -> torch.Tensor:
    """Monte-Carlo eq. (44): samples of the oracle k-th order statistic.
    ``loads`` generalizes the bound to ragged per-worker loads (the k-th
    order statistic over all ``sum(loads)`` active slot arrivals)."""
    return montecarlo.completion_samples(
        montecarlo.lb_spec(r, loads=loads), model, n, trials=trials,
        seed=seed, chunk=chunk, k=k, devices=devices)


def mean_completion_time(C, model, k: int, *, trials: int = 10000,
                         seed: int = 0, chunk: Optional[int] = None,
                         devices=None) -> float:
    """Paper eq. (5): average completion time of schedule C."""
    n = np.asarray(C).shape[0]
    res = montecarlo.sweep([montecarlo.to_spec("to", C)], model, n,
                           trials=trials, seed=seed, chunk=chunk, ks=k,
                           devices=devices)
    return res.at_k("to", k)
