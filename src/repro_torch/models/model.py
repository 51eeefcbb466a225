"""Model assembly of the port (counterpart of ``repro.models.model``).

The JAX package groups the layers into segments (``plan_segments``) and
scans each over stacked weights.  Eager PyTorch needs no scan: the
``Transformer`` holds one block per layer in ``layer_specs`` order, and
``plan_segments`` is kept for ``convert.lm_params``, which unstacks the JAX
segments into those layers.  ``remat`` recomputes each block in backward
(``torch.utils.checkpoint``); ``scan_layers`` changes nothing here.

Weights: ``embed`` (V_pad, d), ``blocks.<l>.{norm1, mixer, norm2, ffn}``,
``final_norm``, ``lm_head`` (absent with tied embeddings), under the JAX
names.  Cache: ``{"layers": [{"attn": {"k", "v", "pos"}}, ...], "pos"}``
with host-integer positions.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import layers as L
from .config import LayerSpec, ModelConfig, find_period, layer_specs

__all__ = ["Segment", "plan_segments", "Block", "Transformer", "block_apply",
           "init_params", "forward", "init_cache", "num_params"]

_OUTSIDE = ("ROADMAP.md queue 1, item 8 (the rest of the LM stack): the "
            "port's LM slice has dense gqa/swa attention and SwiGLU only")


@dataclasses.dataclass(frozen=True)
class Segment:
    specs: Tuple[LayerSpec, ...]   # one period of layer specs
    reps: int                      # scan length


def _run_segments(specs) -> List[Segment]:
    out: List[Segment] = []
    i = 0
    while i < len(specs):
        j = i
        while j < len(specs) and specs[j] == specs[i]:
            j += 1
        out.append(Segment((specs[i],), j - i))
        i = j
    return out


def plan_segments(cfg: ModelConfig) -> Tuple[Segment, ...]:
    """The JAX package's layer grouping: a periodic core plus a run-length
    tail, or pure run-length segments when those give fewer distinct layer
    bodies."""
    specs = layer_specs(cfg)
    p, reps = find_period(specs)
    periodic: List[Segment] = [Segment(specs[:p], reps)]
    periodic += _run_segments(list(specs[p * reps:]))
    runs = _run_segments(list(specs))
    cost_p = sum(len(s.specs) for s in periodic)
    cost_r = sum(len(s.specs) for s in runs)
    return tuple(runs) if cost_r < cost_p else tuple(periodic)


def _check_slice(cfg: ModelConfig) -> None:
    """Raise for what the port's LM slice does not run."""
    for name in ("seq_shard_decode", "grouped_gqa",
                 "attn_batch_shard_fallback", "mla_absorb"):
        if getattr(cfg, name):
            raise NotImplementedError(f"{cfg.name}: mesh variant {name}; "
                                      f"{_OUTSIDE}")
    if cfg.encoder_layers or cfg.arch_type == "audio":
        raise NotImplementedError(f"{cfg.name}: encoders and cross-attention;"
                                  f" {_OUTSIDE}")
    if cfg.frontend:
        raise NotImplementedError(f"{cfg.name}: modality frontend "
                                  f"{cfg.frontend!r}; {_OUTSIDE}")
    for spec in layer_specs(cfg):
        if spec.mixer not in ("gqa", "swa") or spec.ffn != "swiglu":
            raise NotImplementedError(
                f"{cfg.name}: layer ({spec.mixer}, {spec.ffn}); {_OUTSIDE}")
        if spec.mixer == "swa" and cfg.attn_logit_softcap:
            raise NotImplementedError(
                f"{cfg.name}: swa layers with attn_logit_softcap (the JAX "
                f"ring path ignores the softcap that attention_core "
                f"applies; ROADMAP.md section 3)")


class Block(nn.Module):
    """One pre-norm transformer block: x + mixer(norm1(x)), then
    x + ffn(norm2(x))."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, *, device=None):
        super().__init__()
        self.cfg, self.spec = cfg, spec
        dt = getattr(torch, cfg.param_dtype)
        self.norm1 = L.RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dt,
                               device=device)
        self.mixer = L.Attention(cfg, device=device)
        self.norm2 = L.RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dt,
                               device=device)
        self.ffn = L.SwiGLU(cfg, device=device)

    def forward(self, x, *, positions, cache=None):
        return block_apply(self, self.cfg, self.spec, x, positions=positions,
                           cache=cache)


def block_apply(p: Block, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor,
                *, positions: torch.Tensor, cache: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Returns (x, new_cache).  The JAX block also returns an auxiliary
    loss, which only MoE layers make; the port has none."""
    window = cfg.sliding_window if spec.mixer == "swa" else None
    mc = None if cache is None else cache["attn"]
    h, mc = L.gqa_apply(p.mixer, cfg, p.norm1(x), window=window,
                        positions=positions, cache=mc)
    x = x + h
    x = x + p.ffn(p.norm2(x))
    return x, None if cache is None else {**cache, "attn": mc}


class Transformer(nn.Module):
    """The decoder LM: token embedding, one ``Block`` per layer in
    ``layer_specs`` order, final RMS norm and the LM head."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        _check_slice(cfg)
        self.cfg = cfg
        dt = getattr(torch, cfg.param_dtype)
        self.embed = nn.Parameter(torch.empty(
            (cfg.padded_vocab, cfg.d_model), dtype=dt, device=device))
        self.blocks = nn.ModuleList(Block(cfg, spec, device=device)
                                    for spec in layer_specs(cfg))
        self.final_norm = L.RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dt,
                                    device=device)
        self.lm_head = (None if cfg.tie_embeddings else
                        L.Dense(cfg.d_model, cfg.padded_vocab, dtype=dt,
                                device=device))

    def forward(self, tokens: torch.Tensor, *, cache: Optional[dict] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[dict]]:
        """tokens (B, T) -> (logits (B, T, V_pad), aux_loss, new_cache);
        the auxiliary loss is zero (no MoE layers)."""
        cfg = self.cfg
        # F.embedding's backward sums a row's gradients in a fixed order
        # (indexing's index_put_ accumulates in a racy one on the CPU)
        x = F.embedding(tokens, self.embed).to(getattr(torch, cfg.dtype))
        T = x.shape[1]
        pos0 = 0 if cache is None else cache["pos"]
        positions = pos0 + torch.arange(T, device=x.device)[None, :]
        # cfg.remat: recompute each block's activations in backward, as the
        # JAX package checkpoints each layer group (repro/models/model.py:278)
        remat = cfg.remat and cache is None and torch.is_grad_enabled() \
            and self.embed.requires_grad
        new_layers = []
        for i, block in enumerate(self.blocks):
            c = None if cache is None else cache["layers"][i]
            if remat:
                x, c = checkpoint(block, x, positions=positions,
                                  use_reentrant=False)
            else:
                x, c = block(x, positions=positions, cache=c)
            new_layers.append(c)
        x = self.final_norm(x)
        logits = (x @ self.embed.to(x.dtype).T if self.lm_head is None
                  else self.lm_head(x))
        if cfg.padded_vocab != cfg.vocab_size:        # mask the padded tail
            pad = torch.arange(cfg.padded_vocab, device=x.device) >= \
                cfg.vocab_size
            logits = logits.masked_fill(pad, -1e9)
        new_cache = (None if cache is None else
                     {"layers": new_layers, "pos": pos0 + T})
        return logits, torch.zeros((), device=x.device), new_cache


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None,
                trainable: bool = False) -> Transformer:
    """A ``Transformer`` with the JAX package's initialisation (embeddings
    N(0, 1/d), projections N(0, 1/d_in), biases zero, norm scales one)
    drawn by ``layers.init_weights_`` under ``seed``: a function of (cfg,
    seed) alone, the same weights on every device.  On the ``meta`` device
    only the shapes exist.  Serving weights take no gradients;
    ``trainable=True`` gives weights that do (``train.init_train_state``)."""
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev)
    if dev.type != "meta":
        L.init_weights_(model, seed, {model.embed: cfg.d_model ** -0.5})
    return model.requires_grad_(trainable)


def forward(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor, *,
            cache: Optional[dict] = None):
    """The JAX package's ``forward``: (logits, aux_loss, new_cache)."""
    if cfg != params.cfg:
        raise ValueError(f"config {cfg.name} is not the model's "
                         f"({params.cfg.name})")
    return params(tokens, cache=cache)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> dict:
    """Per-layer KV caches (a ring of min(window, max_len) slots for swa
    layers) and the host position 0."""
    dev = resolve_device(device)
    return {"layers": [{"attn": L.gqa_cache_init(
        cfg, batch, max_len, device=dev,
        window=cfg.sliding_window if spec.mixer == "swa" else None)}
        for spec in layer_specs(cfg)], "pos": 0}


def num_params(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())
