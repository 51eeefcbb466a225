"""Model assembly of the port (counterpart of ``repro.models.model``).

The JAX package groups the layers into segments (``plan_segments``) and
scans each over stacked weights.  Eager PyTorch needs no scan: the
``Transformer`` holds one block per layer in ``layer_specs`` order, and
``plan_segments`` is kept for ``convert.lm_params``, which unstacks the JAX
segments into those layers.  ``remat`` recomputes each block in backward
(``torch.utils.checkpoint``); ``scan_layers`` changes nothing here.

Weights: ``embed`` (V_pad, d), ``blocks.<l>.{norm1, mixer, norm2, ffn}``
(plus ``norm_x``, ``xattn`` in a decoder layer with cross-attention),
``final_norm``, ``lm_head`` (absent with tied embeddings), for whisper
``pos_embed`` and ``encoder.{blocks.<l>, final_norm}``, and with a
modality frontend ``frontend_proj``, under the JAX names.  Cache:
``{"layers": [...], "pos"}`` with host-integer positions; a layer holds
``attn`` ({"k", "v", "pos"}, or for MLA {"c_kv", "k_rope", "pos"}) or
``ssm``, the recurrent state (rwkv6: {"S", "x_prev"}; mamba: {"h",
"conv"}), plus ``cmix_prev`` and ``xk``/``xv`` where its layer has them;
``pos`` counts every token, whichever layers attend.  ``forward`` returns
the MoE layers' summed load-balance loss beside the logits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..sharding import (DATA, MODEL, current_mesh_ctx, mesh_context,
                        reduce_partial, shard, unflatten)
from . import layers as L
from .config import LayerSpec, ModelConfig, find_period, layer_specs

__all__ = ["Segment", "plan_segments", "Block", "Encoder", "Transformer",
           "block_apply", "block_cache_init", "sinusoid",
           "init_params", "forward", "encode", "init_cache", "num_params",
           "active_params", "ENC_SPEC"]

_OUTSIDE = ("the port's LM stack has dense gqa/swa attention, MLA, the "
            "RWKV-6 time-mix and the Mamba mixer (hybrid stacks too) with "
            "SwiGLU, GELU, the channel-mix or MoE, the audio and "
            "vision-stub frontends and the whisper encoder-decoder, on one "
            "device or a mesh (launch/mesh.py); other frontends and "
            "layers are outside it")
#: the layers of whisper's encoder (repro/models/model.py:329)
ENC_SPEC = LayerSpec(mixer="gqa", ffn="gelu", cross_attn=False)


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
    """Raise for what the port's LM stack does not run.  Every variant
    flag runs: ``mla_absorb`` and ``grouped_gqa`` change a decode on one
    device; ``seq_shard_decode`` and ``attn_batch_shard_fallback`` act only
    under a mesh context whose model axis is wider than 1, and without
    one the model takes the plain path."""
    if cfg.frontend not in (None, "audio_stub", "vision_stub"):
        raise NotImplementedError(f"{cfg.name}: modality frontend "
                                  f"{cfg.frontend!r}; {_OUTSIDE}")
    for spec in layer_specs(cfg):
        if spec.mixer not in _MIXERS or \
                spec.ffn not in ("swiglu", "gelu", "cmix", "moe"):
            raise NotImplementedError(
                f"{cfg.name}: layer ({spec.mixer}, {spec.ffn}); {_OUTSIDE}")
        if spec.mixer == "swa" and cfg.attn_logit_softcap:
            raise NotImplementedError(
                f"{cfg.name}: swa layers with attn_logit_softcap (the JAX "
                f"ring path ignores the softcap that attention_core "
                f"applies; ROADMAP.md section 3)")


_MIXERS = {"gqa": L.Attention, "swa": L.Attention, "mla": L.MLA,
           "rwkv6": L.RWKV6, "mamba": L.Mamba}
_SSM_APPLY = {"rwkv6": L.rwkv6_apply, "mamba": L.mamba_apply}
_SSM_INIT = {"rwkv6": L.rwkv6_state_init, "mamba": L.mamba_state_init}
_FFNS = {"swiglu": L.SwiGLU, "gelu": L.GeluMLP, "cmix": L.CMix, "moe": L.MoE}


class Block(nn.Module):
    """One pre-norm block: x + mixer(norm1(x)), then (decoder layers of an
    encoder-decoder) x + xattn(norm_x(x)), then x + ffn(norm2(x))."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, *, device=None):
        super().__init__()
        self.cfg, self.spec = cfg, spec
        self.norm1 = L.make_norm(cfg, device=device)
        self.mixer = _MIXERS[spec.mixer](cfg, device=device)
        self.norm2 = L.make_norm(cfg, device=device)
        self.ffn = _FFNS[spec.ffn](cfg, device=device)
        if spec.cross_attn:
            self.norm_x = L.make_norm(cfg, device=device)
            self.xattn = L.Attention(cfg, device=device)

    def forward(self, x, *, positions, cache=None, **kw):
        return block_apply(self, self.cfg, self.spec, x, positions=positions,
                           cache=cache, **kw)


def _cross_kv(p: Block, cfg: ModelConfig, enc_out: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention keys and values of ``enc_out`` (B, T_enc, d),
    repeated to the query heads: (B, H, T_enc, dh) each."""
    K, dh = cfg.n_kv_heads, cfg.head_dim
    kv = [unflatten(f(enc_out), -1, (K, dh)).transpose(1, 2)
          for f in (p.xattn.wk, p.xattn.wv)]
    return tuple(L.repeat_kv(a, cfg.n_heads // K) for a in kv)


def block_apply(p: Block, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor,
                *, positions: torch.Tensor, cache: Optional[dict] = None,
                causal: bool = True, use_rope: bool = True,
                enc_out: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[dict],
                           Optional[torch.Tensor]]:
    """Returns (x, new_cache, aux): ``aux`` is an MoE layer's load-balance
    loss, None for any other layer (the reference's float32 zero, which
    would cost two kernel launches a layer).  A cross-attention layer
    takes its keys and values from ``enc_out`` when given (and stores them
    in the cache as ``xk``/``xv``), else from the cache."""
    new = None if cache is None else dict(cache)
    aux = None
    h = p.norm1(x)
    if spec.mixer in _SSM_APPLY:
        h, st = _SSM_APPLY[spec.mixer](
            p.mixer, cfg, h, state=None if cache is None else cache["ssm"])
        if new is not None:
            new["ssm"] = st
    elif spec.mixer == "mla":
        h, mc = L.mla_apply(p.mixer, cfg, h, positions=positions,
                            cache=None if cache is None else cache["attn"])
        if new is not None:
            new["attn"] = mc
    elif spec.mixer in ("gqa", "swa"):
        window = cfg.sliding_window if spec.mixer == "swa" else None
        h, mc = L.gqa_apply(p.mixer, cfg, h, window=window,
                            positions=positions,
                            cache=None if cache is None else cache["attn"],
                            use_rope=use_rope, causal=causal)
        if new is not None:
            new["attn"] = mc
    else:
        raise ValueError(spec.mixer)
    x = x + reduce_partial(h)
    if spec.cross_attn:
        if enc_out is not None:
            kv = _cross_kv(p, cfg, enc_out)
            if new is not None:
                new["xk"], new["xv"] = kv
        elif cache is not None and cache["xk"] is not None:
            kv = cache["xk"], cache["xv"]
        else:
            # the reference would attend to the zeros its init_cache
            # allocates (ROADMAP.md section 3)
            raise ValueError("cross-attention needs enc_frames, or a cache "
                             "whose prefill was given them")
        h, _ = L.gqa_apply(p.xattn, cfg, p.norm_x(x), xattn_kv=kv)
        x = x + reduce_partial(h)
    h = p.norm2(x)
    if spec.ffn == "cmix":
        h, last = L.cmix_apply(p.ffn, h,
                               prev=None if cache is None
                               else cache["cmix_prev"])
        if new is not None:
            new["cmix_prev"] = last
    elif spec.ffn == "moe":
        h, aux = L.moe_apply(p.ffn, cfg, h)
    else:
        h = p.ffn(h)
    return x + reduce_partial(h), new, aux


def block_cache_init(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, *, device=None) -> dict:
    """A layer's cache: the KV cache of an attention layer (a ring of
    min(window, max_len) slots for swa), the latents and rotary keys of an
    MLA layer, the recurrent state of an rwkv6 or a mamba layer, the
    channel-mix's last input, and the cross-attention keys and values
    (None until a prefill with ``enc_frames`` sets them)."""
    c: dict = {}
    if spec.mixer in _SSM_INIT:
        c["ssm"] = _SSM_INIT[spec.mixer](cfg, batch, device=device)
    elif spec.mixer == "mla":
        c["attn"] = L.mla_cache_init(cfg, batch, max_len, device=device)
    elif spec.mixer in ("gqa", "swa"):
        c["attn"] = L.gqa_cache_init(
            cfg, batch, max_len, device=device,
            window=cfg.sliding_window if spec.mixer == "swa" else None)
    else:
        raise ValueError(spec.mixer)
    if spec.ffn == "cmix":
        c["cmix_prev"] = torch.zeros((batch, cfg.d_model),
                                     dtype=getattr(torch, cfg.dtype),
                                     device=device)
    if spec.cross_attn:
        c["xk"] = c["xv"] = None
    return c


def sinusoid(seq: int, d: int, *, device=None) -> torch.Tensor:
    """The encoder's fixed positions (seq, d) float32: sin in the even
    columns, cos in the odd ones (interleaved, not halves)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(1e4) / d))
    pe = torch.zeros((seq, d), device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


class Encoder(nn.Module):
    """Whisper's encoder stack: ``encoder_layers`` blocks of (gqa, gelu),
    not causal and without RoPE, and a final norm."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.blocks = nn.ModuleList(Block(cfg, ENC_SPEC, device=device)
                                    for _ in range(cfg.encoder_layers))
        self.final_norm = L.make_norm(cfg, device=device)


def _run(block: Block, x: torch.Tensor, remat: bool, **kw):
    """``block(x, **kw)``, its activations recomputed in backward when
    ``remat`` (no cache then).  The recomputation runs under the
    forward's mesh context: autograd runs a CUDA backward on a thread of
    its own, where the thread-local context is unset, and the block would
    take its one-device paths on the mesh's tensors."""
    if remat:
        ctx = current_mesh_ctx()

        def under_ctx(*args, **kwargs):
            with mesh_context(ctx):
                return block(*args, **kwargs)

        return checkpoint(under_ctx, x, use_reentrant=False, **kw)
    return block(x, **kw)


class Transformer(nn.Module):
    """The LM: token embedding (plus the learned ``pos_embed`` of the audio
    family), one ``Block`` per layer in ``layer_specs`` order, final norm
    and the LM head; with a frontend, its ``frontend_proj`` (the encoder's
    input with ``encoder_layers``, else the projection of the embeddings
    that ``forward(embeds=)`` prepends); with ``encoder_layers``, the
    ``encoder``."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        _check_slice(cfg)
        self.cfg = cfg
        dt = getattr(torch, cfg.param_dtype)
        self.embed = nn.Parameter(torch.empty(
            (cfg.padded_vocab, cfg.d_model), dtype=dt, device=device))
        self.blocks = nn.ModuleList(Block(cfg, spec, device=device)
                                    for spec in layer_specs(cfg))
        self.final_norm = L.make_norm(cfg, device=device)
        self.lm_head = (None if cfg.tie_embeddings else
                        L.Dense(cfg.d_model, cfg.padded_vocab, dtype=dt,
                                device=device))
        self.pos_embed = (nn.Parameter(torch.empty(
            (cfg.max_seq_len, cfg.d_model), dtype=dt, device=device))
            if cfg.arch_type == "audio" else None)
        self.frontend_proj = (L.Dense(cfg.frontend_dim, cfg.d_model,
                                      bias=True, dtype=dt, device=device)
                              if cfg.frontend else None)
        self.encoder = (Encoder(cfg, device=device) if cfg.encoder_layers
                        else None)

    def _remat(self, cache) -> bool:
        # cfg.remat: recompute each block's activations in backward, as the
        # JAX package checkpoints each layer group
        # (repro/models/model.py:278); here the encoder's blocks too,
        # which the reference keeps (memory only: the same numbers)
        return (self.cfg.remat and cache is None and torch.is_grad_enabled()
                and self.embed.requires_grad)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """Frame embeddings (B, T_enc, frontend_dim) -> (B, T_enc, d):
        ``frontend_proj``, plus the sinusoid, through the encoder blocks and
        its final norm."""
        x = self.frontend_proj(frames.to(getattr(torch, self.cfg.dtype)))
        x = x + sinusoid(x.shape[1], self.cfg.d_model,
                         device=x.device).to(x.dtype)[None]
        positions = torch.arange(x.shape[1], device=x.device)[None]
        remat = self._remat(None)
        for block in self.encoder.blocks:
            x, _, _ = _run(block, x, remat, positions=positions,
                           causal=False, use_rope=False)
        return self.encoder.final_norm(x)

    def forward(self, tokens: torch.Tensor, *, cache: Optional[dict] = None,
                embeds: Optional[torch.Tensor] = None,
                enc_frames: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[dict]]:
        """tokens (B, T) -> (logits (B, P + T, V_pad), aux_loss, new_cache);
        ``aux_loss`` is the float32 sum of the MoE layers' load-balance
        losses (zero without MoE layers).  ``embeds`` (B, P, frontend_dim),
        stub modality tokens, go through ``frontend_proj`` and are
        prepended to the text, so positions (and a cache's ``pos``) cover
        P + T.  ``enc_frames`` (B, T_enc, frontend_dim) runs the encoder;
        its keys and values go into the cache when one is given, so decode
        steps need no frames."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        # F.embedding's backward sums a row's gradients in a fixed order
        # (indexing's index_put_ accumulates in a racy one on the CPU)
        x = shard(F.embedding(tokens, self.embed).to(dt), DATA, None, None,
                  note="embed")
        if embeds is not None:
            if self.frontend_proj is None:
                raise ValueError(f"{cfg.name} has no frontend to project "
                                 f"embeds")
            x = torch.cat([self.frontend_proj(embeds.to(dt)), x], dim=1)
        T = x.shape[1]
        pos0 = 0 if cache is None else cache["pos"]
        positions = pos0 + torch.arange(T, device=x.device)[None, :]
        if self.pos_embed is not None:
            if pos0 + T > self.pos_embed.shape[0]:
                # lax.dynamic_slice_in_dim (repro/models/model.py:370)
                # would clamp the start and reuse earlier positions
                # (ROADMAP.md section 3)
                raise ValueError(
                    f"{cfg.name}: positions up to {pos0 + T} past the "
                    f"{self.pos_embed.shape[0]} learned ones (max_seq_len)")
            x = x + self.pos_embed[pos0:pos0 + T].to(x.dtype)[None]
        enc_out = (self.encode(enc_frames)
                   if enc_frames is not None and self.encoder is not None
                   else None)
        remat = self._remat(cache)
        kw = dict(positions=positions, use_rope=cfg.arch_type != "audio",
                  enc_out=enc_out)
        new_layers = []
        aux = torch.zeros((), device=x.device)
        for i, block in enumerate(self.blocks):
            x, c, a = _run(block, x, remat, cache=None if cache is None
                           else cache["layers"][i], **kw)
            new_layers.append(c)
            if a is not None:
                aux = aux + a
        x = self.final_norm(x)
        logits = (x @ self.embed.to(x.dtype).T if self.lm_head is None
                  else self.lm_head(x))
        logits = shard(logits, DATA, None, MODEL, note="logits")
        if cfg.padded_vocab != cfg.vocab_size:        # mask the padded tail
            pad = torch.arange(cfg.padded_vocab, device=x.device) >= \
                cfg.vocab_size
            logits = logits.masked_fill(pad, -1e9)
        new_cache = (None if cache is None else
                     {"layers": new_layers, "pos": pos0 + T})
        return logits, aux, new_cache


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None,
                trainable: bool = False) -> Transformer:
    """A ``Transformer`` with the JAX package's initialisation (embeddings
    N(0, 1/d), the audio family's ``pos_embed`` N(0, 0.01^2), projections
    N(0, 1/d_in), biases zero, norm scales one, the RWKV and Mamba leaves'
    constants, scales and fixed values) drawn by ``layers.init_weights_``
    under ``seed``: a function of (cfg, seed) alone, the same weights on
    every device.  On
    the ``meta`` device only the shapes exist.  Serving weights take no
    gradients; ``trainable=True`` gives weights that do
    (``train.init_train_state``)."""
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev)
    if dev.type != "meta":
        scales = {model.embed: cfg.d_model ** -0.5}
        if model.pos_embed is not None:
            scales[model.pos_embed] = 0.01
        L.init_weights_(model, seed, scales)
    return model.requires_grad_(trainable)


def forward(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor, *,
            embeds: Optional[torch.Tensor] = None,
            enc_frames: Optional[torch.Tensor] = None,
            cache: Optional[dict] = None):
    """The JAX package's ``forward``: (logits, aux_loss, new_cache)."""
    if cfg != params.cfg:
        raise ValueError(f"config {cfg.name} is not the model's "
                         f"({params.cfg.name})")
    return params(tokens, cache=cache, embeds=embeds, enc_frames=enc_frames)


def encode(params: Transformer, cfg: ModelConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``encode``: (B, T_enc, frontend_dim) frames ->
    (B, T_enc, d)."""
    if cfg != params.cfg:
        raise ValueError(f"config {cfg.name} is not the model's "
                         f"({params.cfg.name})")
    return params.encode(frames)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> dict:
    """Per-layer caches (``block_cache_init``) and the host position 0."""
    dev = resolve_device(device)
    return {"layers": [block_cache_init(cfg, spec, batch, max_len,
                                        device=dev)
                       for spec in layer_specs(cfg)], "pos": 0}


def num_params(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


def active_params(cfg: ModelConfig) -> int:
    """The reference's approximate active parameter count (an MoE layer
    counts its top-K and shared experts and its router), for model FLOPs
    6 N_active D (repro/models/model.py:411-458)."""
    d, V = cfg.d_model, cfg.padded_vocab
    total = V * d * (1 if cfg.tie_embeddings else 2)
    gqa = d * cfg.head_dim * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
    for s in layer_specs(cfg):
        if s.mixer in ("gqa", "swa"):
            total += gqa
        elif s.mixer == "mla":
            H, R = cfg.n_heads, cfg.kv_lora_rank
            qk = cfg.qk_nope_dim + cfg.qk_rope_dim
            total += d * R + R * H * (cfg.qk_nope_dim + cfg.v_head_dim)
            total += d * cfg.qk_rope_dim
            if cfg.q_lora_rank:
                total += d * cfg.q_lora_rank + cfg.q_lora_rank * H * qk
            else:
                total += d * H * qk
            total += H * cfg.v_head_dim * d
        elif s.mixer == "mamba":
            di = cfg.d_inner
            dt_rank = max(1, math.ceil(d / 16))
            total += d * 2 * di + cfg.d_conv * di + \
                di * (dt_rank + 2 * cfg.d_state) + dt_rank * di + di * d
        elif s.mixer == "rwkv6":
            total += 6 * d * d
        if s.cross_attn:
            total += gqa
        if s.ffn == "swiglu":
            total += 3 * d * cfg.d_ff
        elif s.ffn == "gelu":
            total += 2 * d * cfg.d_ff
        elif s.ffn == "cmix":
            total += 2 * d * cfg.d_ff + d * d
        elif s.ffn == "moe":
            f = cfg.d_ff_expert or cfg.d_ff
            total += 3 * d * f * (cfg.experts_per_token
                                  + cfg.n_shared_experts)
            total += d * cfg.n_experts
    if cfg.encoder_layers:
        total += cfg.encoder_layers * (gqa + 2 * d * cfg.d_ff)
    return total
