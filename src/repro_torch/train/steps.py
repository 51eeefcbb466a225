"""Train and serve steps of the port (counterpart of ``repro.train.steps``).

``make_straggler_train_step`` is the paper's technique put to work: one SGD
iteration is one scheduling round.  The n logical workers each evaluate
their r TO-assigned micro-batches in slot order, and the first-k-distinct
winner mask (``core.completion``) weights the per-(worker, slot) losses so
that the gradient is the unbiased eq.-(61) estimator:

    grad( sum_{i,s} w[i,s] * loss_{i,s} / wsum ) = (1/wsum) sum w[i,s] g_{i,s}

The round's virtual completion time is a step metric.  Delays come from a
stateful ``DelayProcess`` whose per-worker straggler state is passed from
step to step (``cluster``), keyed as the engine keys a trajectory: trial id
0, ``rng.round_seed(seed, 0)`` for the initial state and
``rng.round_seed(seed, t + 1)`` for the round of step t.  A training run's
delays are then the engine's trial-0 tables (``montecarlo._capture_tables``).

The port runs eagerly: a step updates its ``TrainState`` in place (the
model's weights, the optimizer's moments) and returns it.  The slots run in
order, each with its own backward, so only one slot's activations are alive
at a time; the gradients accumulate in the weights' ``.grad``.  The
optimizer then walks the tensors one at a time (``Optimizer.step_``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core import rng
from ..core.cluster import as_process
from ..core.completion import (apply_row_layout, message_arrival_times,
                               message_slot_layout, row_layout_is_identity,
                               winner_mask_gather)
from ..core.montecarlo import task_arrival_times_gather, task_gather_plan
from ..core.scheduling import loads_of_matrix
from ..core.spec import RoundConfig
from ..models import forward, init_params
from ..models.config import ModelConfig
from ..models.model import Transformer
from ..optim import Optimizer, clip_scale, global_norm
from ..sharding import DATA, gather, shard

__all__ = ["TrainState", "init_train_state", "lm_loss_per_seq", "lm_loss",
           "make_train_step", "make_straggler_train_step", "make_serve_step",
           "gumbel_scores", "SAMPLE_STREAM"]

#: the global-norm clip of every train step's gradient (the reference's
#: default, the only value its trainer and examples use)
CLIP_NORM = 1.0


@dataclasses.dataclass
class TrainState:
    """The model (its weights), the optimizer's state (``step`` and its
    moments keyed by parameter name) and the number of steps taken."""
    params: Transformer
    opt_state: dict
    step: int = 0

    def named_params(self) -> Dict[str, torch.Tensor]:
        return dict(self.params.named_parameters())

    def tree(self) -> tuple:
        """The state as a checkpoint tree: (weights by name, optimizer
        state, step), the order in which the JAX package flattens its
        ``TrainState``."""
        return (self.named_params(), self.opt_state, self.step)

    def load_tree(self, tree) -> "TrainState":
        """Take the weights (copied in place), the optimizer state and the
        step of a tree shaped as ``tree()`` gives it; returns ``self``."""
        params, self.opt_state, self.step = tree
        with torch.no_grad():
            for name, p in self.params.named_parameters():
                p.copy_(params[name])
        return self


def init_train_state(cfg: ModelConfig, opt: Optimizer, *, seed: int = 0,
                     device=None) -> TrainState:
    """Trainable weights drawn from ``seed`` on ``device`` (the card by
    default) and a fresh optimizer state beside them."""
    model = init_params(cfg, seed=seed, device=device, trainable=True)
    return TrainState(model, opt.init(dict(model.named_parameters())), 0)


def lm_loss_per_seq(params: Transformer, cfg: ModelConfig,
                    tokens: torch.Tensor, labels: torch.Tensor, *,
                    embeds: Optional[torch.Tensor] = None,
                    enc_frames: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sequence next-token cross-entropy (B,), in float32; returns
    (losses, aux).  ``embeds`` (B, P, frontend_dim) are prepended stub
    modality tokens (the loss is taken on the text positions only);
    ``enc_frames`` (B, T_enc, frontend_dim) feed the encoder of an
    encoder-decoder (whisper)."""
    logits, aux, _ = forward(params, cfg, tokens, embeds=embeds,
                             enc_frames=enc_frames)
    if embeds is not None:
        logits = logits[:, embeds.shape[1]:]
    lp = torch.log_softmax(logits.float(), dim=-1)
    del logits
    ll = lp.gather(-1, labels[..., None].long())[..., 0]
    return -ll.mean(dim=-1), aux


def lm_loss(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor, *,
            embeds: Optional[torch.Tensor] = None,
            enc_frames: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token cross-entropy; returns (loss, aux)."""
    losses, aux = lm_loss_per_seq(params, cfg, tokens, labels,
                                  embeds=embeds, enc_frames=enc_frames)
    return losses.mean(), aux


def _apply_grads(state: TrainState, opt: Optimizer) -> torch.Tensor:
    """Clip the accumulated ``.grad`` of every weight to ``CLIP_NORM`` by
    the global norm, take the optimizer step in place, drop the gradients
    and return the pre-clip norm."""
    params = state.named_params()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in params.items()}
    gnorm = global_norm(grads)
    state.opt_state = opt.step_(params, grads, state.opt_state,
                                clip_scale(gnorm, CLIP_NORM))
    del grads
    for p in params.values():
        p.grad = None
    state.step += 1
    return gnorm


def make_train_step(cfg: ModelConfig, opt: Optimizer):
    """Plain synchronous data-parallel step (the baseline, k = n, r = 1):
    ``step(state, tokens, labels, extras=None) -> (state, metrics)``;
    ``extras`` are keyword inputs of the loss (``embeds``,
    ``enc_frames``)."""
    def step(state: TrainState, tokens, labels, extras=None):
        l, aux = lm_loss(state.params, cfg, tokens, labels, **(extras or {}))
        (l + cfg.router_aux_coef * aux).backward()
        gnorm = _apply_grads(state, opt)
        return state, {"loss": l.detach(), "aux": aux.detach(),
                       "grad_norm": gnorm}

    return step


def make_straggler_train_step(cfg: ModelConfig, opt: Optimizer,
                              config: RoundConfig, delay):
    """The paper's scheduled round as an SGD step:

        step(state, slot_tokens, slot_labels, seed, cluster=None,
             row_of_worker=None, extras=None) -> (state, metrics, cluster)

    ``slot_tokens``/``slot_labels`` (r, n, b, S) come from
    ``data.lm_task_batches``; ``seed`` (below 2**32) keys the run's delays
    with the round index ``state.step``; ``cluster`` is the previous
    round's process state (``None`` starts a fresh cluster); the optional
    ``row_of_worker`` permutation re-assigns the base matrix's rows to
    workers (adaptive schedules: the data must then come from
    ``C[row_of_worker]``); ``extras`` are slot-major modality inputs of
    the loss, e.g. ``enc_frames`` (r, n, b, T_enc, D) for whisper or
    ``embeds`` (r, n, b, P, D) for a vision-stub model, each slot's
    flattened worker-major like its tokens.  ``metrics`` holds ``loss``,
    ``aux`` (the MoE load-balance loss, each slot's weighted by its share of
    the round's winners), ``grad_norm``, the round's ``completion_time``
    (eq. 6), ``winners``,
    ``realized_k``, ``delivered_tasks``, ``deadline_missed``, the
    per-worker mean compute delays ``worker_t1`` (adaptive feedback), the
    raw draws ``slot_t1``/``slot_t2`` (``launch/train.py --log-delays``)
    and the worker-major winner ``weights`` (n, r).

    The worker axis is flattened into the batch (worker-major), so each
    slot is one forward of n * b sequences whose per-sequence losses the
    winner mask weights.  Ragged rounds (``config.loads``): masked slots get
    +inf arrivals, zero weight and all-zero micro-batches; ``comm_eps`` adds
    the per-message overhead to every arrival; a ``close_partial`` or
    ``reissue`` deadline caps the winner selection.  Load re-balancing is
    not a training schedule (nor in the JAX package)."""
    if not isinstance(config, RoundConfig):
        raise TypeError(f"make_straggler_train_step takes a RoundConfig, got "
                        f"{type(config).__name__}")
    if config.rebalance:
        raise ValueError("load re-balancing has no training step; use the "
                         "rounds engine (montecarlo.sweep_rounds)")
    n, r, k = config.n, config.width, config.k
    process = as_process(delay)
    base_C = config.to_matrix()              # ragged rows carry their loads
    plan_np = task_gather_plan(base_C, n)
    plans: Dict[torch.device, torch.Tensor] = {}
    dl_close = (config.deadline if config.deadline is not None
                and config.deadline_policy != "wait" else None)
    # static per-row message layout (closing-slot remap, per-message
    # overhead, ragged masks); None when it is the identity
    layout = message_slot_layout(loads_of_matrix(base_C), r,
                                 config.n_messages, config.comm_eps)
    if row_layout_is_identity(layout):
        layout = None

    def row_arrivals(s):
        return s if layout is None else apply_row_layout(s, layout)

    def step(state: TrainState, slot_tokens, slot_labels, seed: int,
             cluster=None, row_of_worker=None, extras=None):
        model = state.params
        dev = model.embed.device
        if dev not in plans:
            plans[dev] = torch.as_tensor(plan_np, dtype=torch.int64,
                                         device=dev)
        plan = plans[dev]
        b = slot_tokens.shape[2]
        # --- cluster round: stateful delays + first-k-distinct weights ----
        tid = torch.zeros(1, dtype=torch.int64, device=dev)
        if cluster is None:
            cluster = process.init_trials(rng.round_seed(seed, 0), tid, n)
        cluster, T1, T2 = process.step(
            cluster, rng.round_seed(seed, state.step + 1), tid, n, r)
        s = message_arrival_times(T1, T2, r)[0]              # eq. (1)
        if row_of_worker is None:
            row_arr = row_arrivals(s)
            weights, t_done = winner_mask_gather(base_C, plan, row_arr, n, k,
                                                 deadline=dl_close)
        else:
            row_of_worker = torch.as_tensor(np.asarray(row_of_worker),
                                            dtype=torch.int64, device=dev)
            worker_of_row = torch.argsort(row_of_worker)    # inverse perm
            row_arr = row_arrivals(s[worker_of_row])
            w2, t_done = winner_mask_gather(base_C, plan, row_arr, n, k,
                                            deadline=dl_close)
            weights = w2[row_of_worker]                      # worker-major
        # per-task delivery by the (capped) round close: the reissue
        # policy's re-gather priority
        tau = task_arrival_times_gather(plan, row_arr)
        delivered = (tau <= t_done) & torch.isfinite(tau)
        # realized selected-task count: k with per-slot sends, more with a
        # reduced message budget, fewer (even 0) under faults or deadlines;
        # an empty round gives a zero gradient, not NaN
        wsum_raw = weights.sum()
        wsum = torch.where(wsum_raw > 0, wsum_raw, torch.ones_like(wsum_raw))

        loss = torch.zeros((), device=dev)
        aux = torch.zeros((), device=dev)
        for slot in range(r):
            toks = slot_tokens[slot].reshape(n * b, -1)      # worker-major
            toks = shard(toks, DATA, None, note="slot.tokens")
            labs = slot_labels[slot].reshape(n * b, -1)
            kw = {key: v[slot].reshape((n * b,) + v.shape[3:])
                  for key, v in (extras or {}).items()}
            losses, a = lm_loss_per_seq(model, cfg, toks, labs, **kw)
            w_seq = weights[:, slot].repeat_interleave(b) / (wsum * b)
            l_s = (w_seq * losses).sum()                     # eq. (61)
            a_s = a * (weights[:, slot].sum() / wsum)
            (l_s + cfg.router_aux_coef * a_s).backward()
            loss = loss + l_s.detach()
            aux = aux + a_s.detach()
            del losses, l_s
        gnorm = _apply_grads(state, opt)
        if config.deadline is None:
            missed = torch.zeros((), dtype=torch.bool, device=dev)
        elif dl_close is not None:
            missed = wsum_raw < k
        else:
            missed = t_done > config.deadline
        metrics = {"loss": loss, "aux": aux, "grad_norm": gnorm,
                   "completion_time": t_done,
                   "winners": (weights > 0).sum(),
                   "realized_k": wsum_raw,
                   "delivered_tasks": delivered,
                   "deadline_missed": missed,
                   "worker_t1": T1[0].mean(dim=-1),
                   "slot_t1": T1[0], "slot_t2": T2[0],
                   "weights": weights}
        return state, metrics, cluster

    return step


#: the Philox stream of a sampled decode step's uniforms ("SAMP")
SAMPLE_STREAM = 0x53414D50


def gumbel_scores(logits: torch.Tensor, key) -> torch.Tensor:
    """The Gumbel-max scores of a sampled decode step: ``logits`` (B, V)
    in float32 plus ``-log(-log(u))``, ``u`` from ``rng.uniform`` under
    the seed ``rng.round_seed(seed, step)`` of ``key = (seed, step)``,
    trial id = the batch row, element index = the vocabulary index and a
    stream of its own (``SAMPLE_STREAM``).  The argmax of a row is a draw
    from its softmax.  ``uniform`` lies on [0, 1) in steps of 2**-24: a
    0 is taken as 2**-25, the centre of its bin, so every score is finite.
    The noise then lies in [-log(25 log 2), -log(-log(1 - 2**-24))] =
    [-2.853, 16.636]: a token more than 19.5 below its row's maximum
    logit is never drawn (the padded vocabulary's -1e9 tail among them).
    The uniforms are the same bits on every device; the logs may differ
    by an ulp."""
    seed, step = (int(v) for v in key)
    B, V = logits.shape
    tids = torch.arange(B, dtype=torch.int64, device=logits.device)
    u = rng.uniform(rng.round_seed(seed, step), tids, SAMPLE_STREAM, (V,))
    u = torch.where(u > 0, u, torch.full_like(u, 2.0 ** -25))
    return logits.float() - torch.log(-torch.log(u))


def make_serve_step(cfg: ModelConfig, *, greedy: bool = True):
    """One decode step: ``step(model, cache, tokens (B, 1), rng=None) ->
    (next (B, 1) int32, cache, logits (B, V_pad) of the last position)``.
    The JAX step returns only the first two; the logits let a caller
    check them.  With ``greedy`` or no ``rng`` the next token is the first
    maximum (``argmax``); otherwise ``rng`` is the key ``(seed, step)``
    and the next token the Gumbel-max draw of ``gumbel_scores`` (the
    reference draws ``jax.random.categorical``).  Under a mesh the
    vocabulary is gathered first."""
    def step(params, cache, tokens, rng=None):
        logits, _, cache = forward(params, cfg, tokens, cache=cache)
        last = gather(logits[:, -1], -1)
        scores = last if greedy or rng is None else gumbel_scores(last, rng)
        return scores.argmax(dim=-1)[:, None].to(torch.int32), cache, last

    return step
