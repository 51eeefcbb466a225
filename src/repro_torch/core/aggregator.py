"""First-k-distinct gradient aggregation (paper eq. 61); counterpart of
``repro.core.aggregator.StragglerAggregator``.

One SGD iteration = one *round*: worker ``i`` evaluates tasks ``C[i, 0..]``
in order, the round's delays come from a ``DelayProcess`` whose state
persists across ``round_mask`` calls, and the earliest copies of the k
earliest distinct tasks are combined with the unbiased scaling of eq. (61).
Task arrivals go through the engine's static gather plan.

The port's aggregator takes a ``RoundConfig``.  With ``adaptive=True`` it
re-permutes the base matrix's rows every round from observed per-worker
delay feedback (``scheduling.AdaptiveScheduler``, whose greedy assignment
is the ``greedy_assign`` kernel on the card): fetch the coming round's
schedule with ``current_matrix()`` before ``round_mask``.
``censored_feedback`` restricts the feedback to messages that reached the
master by the round's close, and ``dead_after`` presumes long-silent
workers dead.  ``rebalance`` (with ``adaptive``) also re-allocates whole
slots between workers each round under the fixed budget ``sum(loads)``
(per-worker cap ``r``): fetch ``current_loads()`` / ``current_matrix()``
before each round.

Deadlines: ``deadline`` caps each round.  ``wait`` keeps the true
completion and counts the rounds that blew the deadline
(``rounds_missed``); ``close_partial`` closes the round at ``min(t_done,
deadline)`` with whatever arrived (eq. 61 then normalizes by the realized
count); ``reissue`` closes partial and hands the undelivered tasks to the
scheduler as the next round's re-gather priority (``set_need``).
``realized_k_history`` keeps each round's realized count.
``expected_completion`` runs the same policy on the rounds engine
(``montecarlo.sweep_rounds``).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..device import resolve_device
from . import montecarlo, scheduling
from .cluster import IIDProcess, as_process
from .completion import (apply_row_layout, message_arrival_times,
                         message_slot_layout, row_layout_is_identity,
                         winner_mask_gather)
from .spec import RoundConfig
from .trace import TraceProcess

__all__ = ["StragglerAggregator"]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class StragglerAggregator:
    """Combines per-(worker, slot) gradients into the eq.-(61) estimate,
    holding the cluster's straggler state across rounds::

        agg = StragglerAggregator(RoundConfig(n=16, r=2, k=12, kind="ss"),
                                  scenario1(), device="cuda")
        for step in range(steps):
            C = agg.current_matrix()                 # schedule this round
            weights, t_done = agg.round_mask(seed)   # (n, r) weights, scalar
            grad = agg.combine(slot_grads, weights)

    ``seed`` selects the round's random stream (trial id 0 of the process;
    ``rng.round_seed`` gives a run's per-round seeds); ``slot_grads`` is a
    tensor or a dict/list of tensors with leading dims (n, r).
    """

    def __init__(self, config: RoundConfig, delay, *, init_seed=None,
                 device=None):
        if not isinstance(config, RoundConfig):
            raise TypeError(f"StragglerAggregator takes a RoundConfig, got "
                            f"{type(config).__name__}")
        self.config = config
        self.device = resolve_device(device)
        self.process = as_process(delay)
        self.rebalance = config.rebalance
        # rebalance masks slots per round, so its base is the dense cap
        # grid; otherwise the (possibly ragged) schedule bakes its masks in
        self.base_C = (config.base_matrix() if self.rebalance
                       else config.to_matrix())
        n, r = config.n, config.width
        self._plan = torch.as_tensor(
            montecarlo.task_gather_plan(self.base_C, n), dtype=torch.int64,
            device=self.device)
        self.scheduler = None
        if config.adaptive:
            kw = dict(beta=config.feedback_beta, gamma=config.coverage_gamma,
                      device=self.device)
            if config.dead_after is not None:
                kw.update(dead_after=config.dead_after, target_k=config.k)
            if self.rebalance:
                kw.update(loads=config.loads, rebalance=True)
            self.scheduler = scheduling.AdaptiveScheduler(self.base_C, **kw)
        self.censored = config.censored_feedback
        self._row_layout = self._rb_remap = None
        if self.rebalance:
            # loads change every round: the message grouping is the
            # load-indexed closing-slot table, gathered per round
            tab = montecarlo._rebalance_remap_table(r, config.n_messages)
            if tab is not None:
                self._rb_remap = torch.as_tensor(tab, device=self.device)
        else:
            layout = message_slot_layout(config.load_vector, r,
                                         config.n_messages, config.comm_eps)
            if not row_layout_is_identity(layout):
                self._row_layout = layout
        self._tid = torch.zeros(1, dtype=torch.int64, device=self.device)
        self._state = self.process.init_trials(
            config.seed if init_seed is None else init_seed, self._tid, n)
        self._rounds_done = 0
        # close_partial / reissue cap the winner selection at the deadline;
        # "wait" keeps the true completion and only counts the miss
        self._dl_close = (config.deadline if config.deadline is not None
                          and config.deadline_policy != "wait" else None)
        self.rounds_missed = 0
        self.realized_k_history: list[float] = []

    def current_matrix(self):
        """The TO matrix for the coming round (row ``w`` = the tasks worker
        ``w`` executes): the base matrix, or the adaptive re-assignment."""
        if self.scheduler is None:
            return self.base_C
        return self.scheduler.matrix()

    def current_loads(self):
        """Per-worker loads for the coming round."""
        if self.scheduler is None:
            return self.config.load_vector
        return self.scheduler.loads()

    def round_mask(self, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Advance the cluster one round, returning (weights (n, r),
        completion time scalar).  ``weights`` sums to the realized
        distinct-result count (k almost surely without faults or deadlines)
        in ``current_matrix()``'s layout; an adaptive aggregator then feeds
        the round's delays to its scheduler (and, under ``reissue``, the
        tasks the round did not deliver)."""
        cfg = self.config
        n, r = cfg.n, cfg.width
        self.process.check_rounds(self._rounds_done + 1)
        row_of_worker = loads_w = None
        if self.scheduler is not None:
            row_of_worker = torch.as_tensor(self.scheduler.row_of_worker(),
                                            device=self.device)
            if self.rebalance:
                loads_w = torch.as_tensor(self.scheduler.loads(),
                                          device=self.device)
        self._state, T1, T2 = self.process.step(self._state, seed, self._tid,
                                                n, r)
        s = message_arrival_times(T1, T2, r)[0]          # eq. (1)
        if row_of_worker is not None:
            # permute to base-row space; the message layout follows the row
            worker_of_row = torch.argsort(row_of_worker)
            s = s[worker_of_row]
        if self._row_layout is not None:
            s = apply_row_layout(s, self._row_layout)
        if loads_w is not None:
            # row p inherits its executor's re-balanced load this round
            l_row = loads_w[worker_of_row]
            s = torch.where(torch.arange(r, device=self.device)[None, :]
                            < l_row[:, None], s, montecarlo.INF)
            if self._rb_remap is not None:
                s = torch.take_along_dim(s, self._rb_remap[l_row - 1], dim=-1)
        weights, t_done = winner_mask_gather(self.base_C, self._plan, s, n,
                                             cfg.k, deadline=self._dl_close)
        self._rounds_done += 1
        realized = float(weights.sum())
        self.realized_k_history.append(realized)
        if cfg.deadline is not None:
            blown = (float(t_done) > cfg.deadline if self._dl_close is None
                     else realized < cfg.k)
            self.rounds_missed += int(blown)
        if row_of_worker is not None:
            weights = weights[row_of_worker]             # worker-major
            t1 = T1[0].cpu().numpy()
            if self.censored:
                self.scheduler.observe(
                    t1, arrivals=s[row_of_worker].cpu().numpy(),
                    t_done=float(t_done))
            else:
                self.scheduler.observe(t1)
            if cfg.deadline_policy == "reissue":
                # undelivered tasks get re-gather priority next round
                tau = montecarlo.task_arrival_times_gather(self._plan, s)
                delivered = (tau <= t_done) & torch.isfinite(tau)
                self.scheduler.set_need(~delivered.cpu().numpy())
        return weights, t_done

    def combine(self, slot_grads: Any, weights: torch.Tensor) -> Any:
        """eq. (61): the selected tasks' gradients, normalized by the
        realized selected-task count (``weights.sum()``; k with per-slot
        sends); a round that realized nothing yields a zero gradient."""
        den_raw = weights.sum()
        den = torch.where(den_raw > 0, den_raw, torch.ones_like(den_raw))

        def _one(g):
            w = weights.reshape(weights.shape + (1,) * (g.dim() - 2))
            return (g * w).sum(dim=(0, 1)) / den
        return _tree_map(_one, slot_grads)

    def expected_completion(self, seed: int = 0, trials: int = 4096,
                            rounds: int | None = None) -> float:
        """Monte-Carlo estimate of the mean per-round completion time
        (eq. 5) on the rounds engine, for the policy this aggregator runs.
        Stateful processes average ``rounds`` consecutive rounds (default
        8, at most what remains of a replayed trace), the i.i.d. process
        one."""
        cfg = self.config
        if rounds is None:
            rounds = 1 if isinstance(self.process, IIDProcess) else 8
            if isinstance(self.process, TraceProcess):
                rounds = min(rounds, self.process.trace.rounds
                             - int(self.process.start_round))
        kw = {}
        if self.scheduler is not None:
            spec = montecarlo.adaptive_spec(
                "s", self.base_C, messages=cfg.messages,
                **(dict(loads=cfg.loads, rebalance=True) if self.rebalance
                   else {}))
            kw = dict(feedback_beta=self.scheduler.beta,
                      coverage_gamma=self.scheduler.gamma,
                      censored_feedback=self.censored)
        else:
            spec = montecarlo.to_spec("s", self.base_C,
                                      messages=cfg.messages,
                                      comm_eps=cfg.comm_eps)
        if cfg.deadline is not None:
            kw.update(deadline=cfg.deadline,
                      deadline_policy=cfg.deadline_policy)
        res = montecarlo.sweep_rounds(
            [spec], self.process, cfg.n, rounds=rounds, k=cfg.k,
            trials=trials, seed=seed, devices=self.device, **kw)
        return res.mean_round("s")
