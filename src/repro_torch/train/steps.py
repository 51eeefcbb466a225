"""The serving step of the port (``repro.train.steps.make_serve_step``).
Training steps are a later slice (ROADMAP.md)."""
from __future__ import annotations

import torch

from ..models import forward
from ..models.config import ModelConfig

__all__ = ["make_serve_step"]


def make_serve_step(cfg: ModelConfig):
    """One greedy decode step: (model, cache, tokens (B, 1)) -> (next (B, 1)
    int32, cache, logits (B, V_pad) of the last position).  The JAX step
    returns only the first two; the logits let a caller check them.  The
    next token is the first maximum (``argmax``)."""
    def step(params, cache, tokens):
        logits, _, cache = forward(params, cfg, tokens, cache=cache)
        last = logits[:, -1]
        return last.argmax(dim=-1)[:, None].to(torch.int32), cache, last

    return step
