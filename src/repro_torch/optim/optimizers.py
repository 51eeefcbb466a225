"""Optimizers of the port (counterpart of ``repro.optim.optimizers``).

Parameters, gradients and updates are dicts ``{name: tensor}`` keyed by
parameter name (``dict(model.named_parameters())``); the state is
``{"step": int32 0-d tensor, <moment>: {name: float32 tensor}, ...}``.
The arithmetic is the JAX package's, in its order: moments in float32,
bias corrections ``1 - b ** step`` in float32, the AdamW update
``-s * (mhat / (sqrt(vhat) + eps) + wd * p)`` and ``apply`` as
``(p.float() + u).to(p.dtype)``.  The schedule and the bias corrections
are 0-d float32 tensors on the CPU, so the card and the CPU use the same
scalars.

``update``/``apply`` build whole trees as the JAX API does.  Training at
full size cannot hold them (a float32 tree of gemma3-4b is 18.2 GB), so
``step_`` walks the tensors one at a time, in place: scale the gradient,
update the moments, apply.  Every op is elementwise and bf16 -> float32
is exact, so it gives the same bits as ``update`` then ``apply``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

__all__ = ["Schedule", "constant_schedule", "cosine_schedule", "global_norm",
           "clip_by_global_norm", "clip_scale", "Optimizer", "sgd",
           "momentum", "adam", "adamw"]

Tree = Dict[str, torch.Tensor]
Schedule = Callable[[torch.Tensor], torch.Tensor]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant_schedule(lr: float) -> Schedule:
    return lambda step: _f32(lr)


def cosine_schedule(peak: float, total_steps: int, warmup: int = 0,
                    floor: float = 0.0) -> Schedule:
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine decay
    to ``floor`` at ``total_steps``; float32 as in the JAX package."""
    def f(step):
        step = _f32(step)
        warm = step * _f32(peak) / _f32(max(warmup, 1))
        prog = torch.clamp((step - _f32(warmup))
                           / _f32(max(total_steps - warmup, 1)), 0, 1)
        cos = _f32(floor) + _f32((peak - floor) * 0.5) * (
            _f32(1.0) + torch.cos(_f32(math.pi) * prog))
        return torch.where(step < warmup, warm, cos)
    return f


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (a 0-d tensor
    on the leaves' device)."""
    total = None
    for leaf in tree.values():
        sq = leaf.detach().float().square().sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``min(1, max_norm / max(norm, 1e-9))`` in float32."""
    return torch.clamp(_f32(max_norm).to(norm.device)
                       / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """The tree scaled to global norm at most ``max_norm`` (float32 leaves,
    as the JAX package's strong float32 scale makes them) and the norm."""
    g = global_norm(tree)
    scale = clip_scale(g, max_norm)
    return {k: l.float() * scale for k, l in tree.items()}, g


def _sched(lr) -> Schedule:
    return lr if callable(lr) else constant_schedule(lr)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """An optimizer as three pieces: ``moments`` names the float32 state
    trees it keeps, ``scalars(step)`` computes the step's 0-d float32
    scalars (the learning rate, bias corrections) from the pre-update step
    count, and ``leaf(g, mom, p, sc)`` returns one tensor's float32 update
    from its float32 gradient ``g``, updating its moments ``mom`` (a dict
    of tensors) in place."""
    moments: Tuple[str, ...]
    scalars: Callable[[torch.Tensor], dict]
    leaf: Callable[..., torch.Tensor]

    def init(self, params: Tree) -> dict:
        state = {"step": torch.zeros((), dtype=torch.int32)}
        for name in self.moments:
            state[name] = {k: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device)
                           for k, p in params.items()}
        return state

    def _next(self, state: dict) -> dict:
        return {"step": state["step"] + 1,
                **{m: state[m] for m in self.moments}}

    def update(self, grads: Tree, state: dict, params: Optional[Tree] = None
               ) -> Tuple[Tree, dict]:
        """(updates, new state) for whole trees; the old state is kept."""
        sc = self.scalars(state["step"])
        new = {"step": state["step"] + 1}
        for m in self.moments:
            new[m] = {k: v.clone() for k, v in state[m].items()}
        upd = {}
        with torch.no_grad():
            for k, g in grads.items():
                mom = {m: new[m][k] for m in self.moments}
                upd[k] = self.leaf(g.float(), mom,
                                   None if params is None else params[k], sc)
        return upd, new

    @staticmethod
    def apply(params: Tree, updates: Tree) -> Tree:
        with torch.no_grad():
            return {k: (p.float() + updates[k]).to(p.dtype)
                    for k, p in params.items()}

    @torch.no_grad()
    def step_(self, params: Tree, grads: Tree, state: dict,
              scale: Optional[torch.Tensor] = None) -> dict:
        """One step in place, a tensor at a time: ``g = grads[k].float() *
        scale`` (the clip), the moments of ``state`` updated, ``params[k]``
        overwritten with ``(p.float() + u).to(p.dtype)``.  Returns the
        state with its step advanced."""
        sc = self.scalars(state["step"])
        for k, p in params.items():
            g = grads[k].float()
            if scale is not None:
                g = g * scale
            u = self.leaf(g, {m: state[m][k] for m in self.moments}, p, sc)
            del g
            p.copy_(u.add_(p))                      # p.float() + u, cast
            del u
        return self._next(state)


def sgd(lr) -> Optimizer:
    lr = _sched(lr)

    def leaf(g, mom, p, sc):
        return -sc["s"] * g

    return Optimizer((), lambda step: {"s": lr(step)}, leaf)


def momentum(lr, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    lr = _sched(lr)

    def leaf(g, mom, p, sc):
        mu = mom["mu"]
        mu.mul_(beta).add_(g)                       # beta * m + g
        if nesterov:
            return -sc["s"] * (mu * beta + g)
        return -sc["s"] * mu

    return Optimizer(("mu",), lambda step: {"s": lr(step)}, leaf)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
         ) -> Optimizer:
    return adamw(lr, b1=b1, b2=b2, eps=eps, weight_decay=0.0)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    lr = _sched(lr)

    def scalars(step):
        t = _f32(step + 1)
        return {"s": lr(step), "bc1": 1 - _f32(b1) ** t,
                "bc2": 1 - _f32(b2) ** t}

    def leaf(g, mom, p, sc):
        m, v = mom["m"], mom["v"]
        m.mul_(b1).add_(g * (1 - b1))               # b1 * m + (1 - b1) * g
        v.mul_(b2).add_(g.square().mul_(1 - b2))    # b2 * v + (1 - b2) * g^2
        den = (v / sc["bc2"]).sqrt_().add_(eps)     # sqrt(vhat) + eps
        u = (m / sc["bc1"]).div_(den)               # mhat / (...)
        del den
        u.add_(p.float() * weight_decay)            # + wd * p
        return u.mul_(-sc["s"])                     # -s * (...)

    return Optimizer(("m", "v"), scalars, leaf)
