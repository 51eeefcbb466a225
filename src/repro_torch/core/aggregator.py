"""First-k-distinct gradient aggregation (paper eq. 61), static path;
counterpart of ``repro.core.aggregator.StragglerAggregator``.

One SGD iteration = one *round*: worker ``i`` evaluates tasks ``C[i, 0..]``
in order, the round's delays come from a ``DelayProcess`` whose state
persists across ``round_mask`` calls, and the earliest copies of the k
earliest distinct tasks are combined with the unbiased scaling of eq. (61).
Task arrivals go through the engine's static gather plan.

The port's aggregator takes a ``RoundConfig``.  Adaptive row assignment,
load re-balancing and deadlines (``adaptive``, ``rebalance``, ``deadline``)
and ``expected_completion`` (which needs the rounds engine) arrive with the
port's ``greedy_assign`` slice; until then they raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..device import resolve_device
from . import montecarlo
from .cluster import as_process
from .completion import (apply_row_layout, message_arrival_times,
                         message_slot_layout, row_layout_is_identity,
                         winner_mask_gather)
from .spec import RoundConfig

__all__ = ["StragglerAggregator"]

_LATER = ("arrives with the port's greedy_assign slice (rounds axis and "
          "adaptive scheduling)")


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

    ``seed`` selects the round's random stream (trial id 0 of the process);
    ``slot_grads`` is a tensor or a dict/list of tensors with leading dims
    (n, r).
    """

    def __init__(self, config: RoundConfig, delay, *, init_seed=None,
                 device=None):
        if not isinstance(config, RoundConfig):
            raise TypeError(f"StragglerAggregator takes a RoundConfig, got "
                            f"{type(config).__name__}")
        if config.adaptive or config.rebalance:
            raise NotImplementedError(f"adaptive/rebalance rounds {_LATER}")
        if config.deadline is not None:
            raise NotImplementedError(f"round deadlines {_LATER}")
        self.config = config
        self.device = resolve_device(device)
        self.process = as_process(delay)
        self.base_C = config.to_matrix()
        n, r = config.n, config.width
        self._plan = torch.as_tensor(
            montecarlo.task_gather_plan(self.base_C, n), dtype=torch.int64,
            device=self.device)
        layout = message_slot_layout(config.load_vector, r,
                                     config.n_messages, config.comm_eps)
        self._row_layout = None if row_layout_is_identity(layout) else layout
        self._tid = torch.zeros(1, dtype=torch.int64, device=self.device)
        self._state = self.process.init_trials(
            config.seed if init_seed is None else init_seed, self._tid, n)
        self._rounds_done = 0
        self.realized_k_history: list[float] = []

    def current_matrix(self):
        """The TO matrix for the coming round (static: the base matrix)."""
        return self.base_C

    def current_loads(self):
        """Per-worker loads for the coming round."""
        return self.config.load_vector

    def round_mask(self, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Advance the cluster one round, returning (weights (n, r),
        completion time scalar).  ``weights`` sums to the realized
        distinct-result count (k almost surely) in ``current_matrix()``'s
        layout."""
        cfg = self.config
        n, r = cfg.n, cfg.width
        self.process.check_rounds(self._rounds_done + 1)
        self._state, T1, T2 = self.process.step(self._state, seed, self._tid,
                                                n, r)
        s = message_arrival_times(T1, T2, r)[0]          # eq. (1)
        if self._row_layout is not None:
            s = apply_row_layout(s, self._row_layout)
        weights, t_done = winner_mask_gather(self.base_C, self._plan, s, n,
                                             cfg.k)
        self._rounds_done += 1
        self.realized_k_history.append(float(weights.sum()))
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

    def expected_completion(self, *args, **kwargs) -> float:
        raise NotImplementedError(f"expected_completion needs the rounds "
                                  f"engine, which {_LATER}")
