"""Layers of the port's LM stack (counterpart of ``repro.models.layers``
for the dense, audio and RWKV families): projections, RMS and layer norm,
rotary embeddings, the attention core, grouped-query attention with its KV
cache (full or ring buffer) and cross-attention, the SwiGLU and GELU
feed-forwards, and the RWKV-6 time-mix and channel-mix with their token
shift and recurrent state.

Weights keep the JAX layout (a ``dense`` weight is ``(d_in, d_out)`` and is
used as ``x @ w``) and the JAX names, so ``repro_torch.convert.lm_params``
is a copy.  The attention of a sliding-window (``swa``) layer over a chunk
of fresh tokens, with no cache or into an empty ring, is the
``swa_attention`` kernel (``kernels/ops.py``) when no gradient is
recorded; the other attention paths, and that one under autograd, are
torch ops, as the JAX package computes them in jnp.  The RWKV-6
recurrence is a step loop in torch ops, as the JAX package's is a
``lax.scan`` (no Pallas kernel).  KV caches are
updated in place (the JAX package returns new arrays); ``pos`` is a host
integer.

Initialisation (``init_weights_``) is the JAX package's scales drawn from
the port's counter-based Philox (``core/rng.py``): parameter ``i`` of
``named_parameters()`` takes the words of trial ``i``, stream
``INIT_STREAM``, under the model's seed, so the weights are a function of
(config, seed) alone, the same on the card as on the CPU.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core import rng
from ..kernels import ops
from .config import ModelConfig

__all__ = ["dense", "rms_norm", "layer_norm", "rope_freqs", "apply_rope",
           "attention_core", "repeat_kv", "gqa_init", "gqa_apply",
           "gqa_cache_init", "swiglu", "gelu_mlp", "token_shift",
           "cmix_apply", "wkv6", "rwkv6_apply", "rwkv6_state_init",
           "Dense", "RMSNorm", "LayerNorm", "make_norm", "Attention",
           "SwiGLU", "GeluMLP", "CMix", "RWKV6", "init_weights_"]

#: the Philox stream of the initial weights, one that no other draw of the
#: port uses (the delay models take 0-4, the processes 5-8, the fault layers
#: 9 and up, the LM data 0-3), so a model's weights share no words with the
#: tokens or delays drawn under the same seed
INIT_STREAM = 0x494E4954
#: words a parameter is drawn in at a time: no index tensor of a whole
#: embedding (671 M elements in gemma3-4b) is ever made
INIT_SLAB = 1 << 24


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm over the last axis, computed in float32."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """Layer norm over the last axis, computed in float32 as the JAX
    package writes it (the mean of squared deviations), then cast back."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., T, H, dh) or (..., T, dh); positions (..., T).  The head dim
    splits into halves (not interleaved pairs), as in the JAX package."""
    inv = rope_freqs(x.shape[-1], theta, device=x.device)
    ang = positions.float()[..., None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.dim() == positions.dim() + 2:                # head axis present
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention core
# --------------------------------------------------------------------------

def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, q_offset: int, window: Optional[int] = None,
                   kv_len: Optional[int] = None,
                   softcap: Optional[float] = None, chunk_q: int = 2048,
                   chunk_k: int = 1024) -> torch.Tensor:
    """q (B, H, Tq, dh), k/v (B, H, Tk, dh_v) with the same head count (the
    caller repeats GQA's KV heads).  ``q_offset`` is the absolute position
    of q's first row; ``kv_len`` masks cache positions >= it.  Up to
    4096 x 4096 scores the softmax is dense; beyond, an online softmax over
    (chunk_q x chunk_k) score tiles bounds the memory.  Rows with no
    visible key give zeros."""
    B, H, Tq, dh = q.shape
    Tk = k.shape[2]
    scale = 1.0 / math.sqrt(dh)
    dev = q.device
    qpos = q_offset + torch.arange(Tq, device=dev)

    def visible(qp, kp):
        ok = torch.ones((qp.shape[0], kp.shape[0]), dtype=torch.bool,
                        device=dev)
        if causal:
            ok &= kp[None, :] <= qp[:, None]
        if window is not None:
            ok &= kp[None, :] > qp[:, None] - window
        if kv_len is not None:
            ok &= (kp < kv_len)[None, :]
        return ok

    def scores(qc, kc):
        s = torch.einsum("bhqd,bhkd->bhqk", qc.float(), kc.float()) * scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        return s

    if Tq * Tk <= 4096 * 4096 and Tq <= 4096:
        s = scores(q, k).masked_fill(
            ~visible(qpos, torch.arange(Tk, device=dev)), float("-inf"))
        p = torch.softmax(s, dim=-1)
        # rows with every key masked give nan: zero them
        # (repro/models/layers.py:158)
        p = torch.where(torch.isfinite(s).any(-1, keepdim=True), p, 0.0)
        return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)

    # ---- chunked online softmax ----
    eff_len = Tk if kv_len is None else min(Tk, kv_len)
    outs = []
    for q0 in range(0, Tq, chunk_q):
        qc, qp = q[:, :, q0:q0 + chunk_q], qpos[q0:q0 + chunk_q]
        cq = qc.shape[2]
        m = torch.full((B, H, cq), float("-inf"), device=dev)
        l = torch.zeros((B, H, cq), device=dev)
        acc = torch.zeros((B, H, cq, v.shape[-1]), device=dev)
        for k0 in range(0, Tk, chunk_k):
            ks, vs = k[:, :, k0:k0 + chunk_k], v[:, :, k0:k0 + chunk_k]
            kp = k0 + torch.arange(ks.shape[2], device=dev)
            ok = visible(qp, kp) & (kp < eff_len)[None, :]
            s = scores(qc, ks).masked_fill(~ok, float("-inf"))
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            pexp = torch.exp(s - m_safe[..., None])
            pexp = torch.where(torch.isfinite(s), pexp, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + pexp.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", pexp.to(vs.dtype), vs).float()
            m = m_new
        outs.append((acc / l.clamp_min(1e-30)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=2)


def repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, K, T, dh) -> (B, K * groups, T, dh): query head h reads KV head
    h // groups."""
    if groups == 1:
        return x
    B, K, T, dh = x.shape
    return x[:, :, None].expand(B, K, groups, T, dh).reshape(
        B, K * groups, T, dh)


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

class Dense(nn.Module):
    """``x @ w (+ b)`` with ``w`` (d_in, d_out); initialised N(0, scale^2),
    scale 1/sqrt(d_in) unless given, bias zero."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 scale: Optional[float] = None, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.init_scale = 1.0 / math.sqrt(d_in) if scale is None else scale
        self.w = nn.Parameter(torch.empty((d_in, d_out), dtype=dtype,
                                          device=device))
        self.b = (nn.Parameter(torch.empty((d_out,), dtype=dtype,
                                           device=device)) if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.w, self.b)


class RMSNorm(nn.Module):
    """RMS norm with a learned scale (initialised to one), in float32."""

    def __init__(self, d: int, eps: float, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty((d,), dtype=dtype,
                                              device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale, self.eps)


class LayerNorm(nn.Module):
    """Layer norm with a learned ``scale`` (one) and ``bias`` (zero) of
    ``shape``, in float32."""

    def __init__(self, shape, eps: float, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(shape, dtype=dtype,
                                              device=device))
        self.bias = nn.Parameter(torch.empty(shape, dtype=dtype,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, self.eps)


def make_norm(cfg: ModelConfig, *, device=None) -> nn.Module:
    """The config's norm over d_model (``norm_init``): a layer norm for
    the audio family, an RMS norm otherwise."""
    cls = LayerNorm if cfg.arch_type == "audio" else RMSNorm
    return cls(cfg.d_model, cfg.norm_eps,
               dtype=getattr(torch, cfg.param_dtype), device=device)


class Attention(nn.Module):
    """Grouped-query attention's projections ``wq``, ``wk``, ``wv``, ``wo``;
    ``forward`` is ``gqa_apply``."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        dh, H, K = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        dt = getattr(torch, cfg.param_dtype)
        kw = dict(dtype=dt, device=device)
        self.wq = Dense(cfg.d_model, H * dh, bias=cfg.qkv_bias, **kw)
        self.wk = Dense(cfg.d_model, K * dh, bias=cfg.qkv_bias, **kw)
        self.wv = Dense(cfg.d_model, K * dh, bias=cfg.qkv_bias, **kw)
        self.wo = Dense(H * dh, cfg.d_model, scale=1.0 / math.sqrt(H * dh),
                        **kw)

    def forward(self, x, **kw):
        return gqa_apply(self, self.cfg, x, **kw)


class SwiGLU(nn.Module):
    """``w_down(silu(w_gate x) * w_up x)``."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        d_ff = cfg.d_ff
        kw = dict(dtype=getattr(torch, cfg.param_dtype), device=device)
        self.w_gate = Dense(cfg.d_model, d_ff, **kw)
        self.w_up = Dense(cfg.d_model, d_ff, **kw)
        self.w_down = Dense(d_ff, cfg.d_model, scale=1.0 / math.sqrt(d_ff),
                            **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu(self, x)


def swiglu(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    return p.w_down(F.silu(p.w_gate(x)) * p.w_up(x))


class GeluMLP(nn.Module):
    """Whisper's feed-forward: ``w_down(gelu(w_up x))``, both with
    biases."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        kw = dict(dtype=getattr(torch, cfg.param_dtype), device=device)
        self.w_up = Dense(cfg.d_model, cfg.d_ff, bias=True, **kw)
        self.w_down = Dense(cfg.d_ff, cfg.d_model, bias=True,
                            scale=1.0 / math.sqrt(cfg.d_ff), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu_mlp(self, x)


def gelu_mlp(p: GeluMLP, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return p.w_down(F.gelu(p.w_up(x), approximate="tanh"))


# --------------------------------------------------------------------------
# RWKV: token shift, channel-mix, the RWKV-6 time-mix
# --------------------------------------------------------------------------

def token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                ) -> torch.Tensor:
    """x (B, T, d) shifted right by one along T; position 0 gets ``prev``
    (B, d), or zeros."""
    first = (torch.zeros_like(x[:, :1]) if prev is None
             else prev[:, None, :].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


class CMix(nn.Module):
    """The RWKV channel-mix (a squared-ReLU MLP on the token-shifted input
    with a receptance gate).  No configuration of the repo reaches it: its
    layers take SwiGLU (``config.layer_specs``)."""

    INIT_CONST = {"mu_k": 0.5, "mu_r": 0.5}

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        d, d_ff = cfg.d_model, cfg.d_ff
        kw = dict(dtype=getattr(torch, cfg.param_dtype), device=device)
        self.mu_k = nn.Parameter(torch.empty((d,), **kw))
        self.mu_r = nn.Parameter(torch.empty((d,), **kw))
        self.w_k = Dense(d, d_ff, **kw)
        self.w_v = Dense(d_ff, d, scale=1.0 / math.sqrt(d_ff), **kw)
        self.w_r = Dense(d, d, **kw)


def cmix_apply(p: CMix, x: torch.Tensor, prev: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, d) -> (y, x[:, -1], the next call's ``prev``)."""
    xs = token_shift(x, prev)
    xk = x + (xs - x) * p.mu_k.to(x.dtype)
    xr = x + (xs - x) * p.mu_r.to(x.dtype)
    k = torch.square(F.relu(p.w_k(xk)))
    r = torch.sigmoid(p.w_r(xr))
    return r * p.w_v(k), x[:, -1]


class RWKV6(nn.Module):
    """The RWKV-6 (Finch) time-mix: token-shift mixes ``mu`` (r, k, v, w, g),
    projections, the data-dependent decay ``exp(-exp(w0 + lora(x)))``, the
    bonus ``u``, a per-head group norm ``ln_out`` and ``w_o``.  ``w0``,
    ``u`` and ``ln_out`` are float32 in every model, as in the JAX
    package."""

    INIT_CONST = {"mu": 0.5, "w0": -6.0}
    INIT_STD = {"u": 0.1}

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        dh = d // H
        lora = max(32, d // 32)
        f32 = dict(dtype=torch.float32, device=device)
        kw = dict(dtype=getattr(torch, cfg.param_dtype), device=device)
        self.mu = nn.Parameter(torch.empty((5, d), **kw))
        self.w_r = Dense(d, d, **kw)
        self.w_k = Dense(d, d, **kw)
        self.w_v = Dense(d, d, **kw)
        self.w_g = Dense(d, d, **kw)
        self.w0 = nn.Parameter(torch.empty((d,), **f32))
        self.w_lora_a = Dense(d, lora, **kw)
        self.w_lora_b = Dense(lora, d, scale=0.01, **kw)
        self.u = nn.Parameter(torch.empty((H, dh), **f32))
        self.ln_out = LayerNorm((H, dh), 1e-5, **f32)
        self.w_o = Dense(d, d, scale=1.0 / math.sqrt(d), **kw)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, S: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RWKV-6 recurrence in float32.  r, k, v, w (B, T, H, dh), u (H,
    dh), S (B, H, dh, dh); returns (y (B, T, H, dh), S after the last
    token).  Per token, as the JAX package's ``lax.scan`` step:

        y_t = r_t (S + diag(u) k_t v_tᵀ),   S <- diag(w_t) S + k_t v_tᵀ

    The bonus term r_t diag(u) k_t v_tᵀ = (r_t · u k_t) v_t is taken for
    every token at once; the loop is then three launches a token (``r_t
    S``, ``w_t S``, the rank-one update), with nothing read back to the
    host."""
    B, T, H, dh = r.shape
    bonus = (r * u * k).sum(-1, keepdim=True) * v

    def steps(a, last):                       # (T, B*H, ...) step-major
        return a.permute(1, 0, 2, 3).reshape((T, B * H) + last)

    rs, ks = steps(r, (1, dh)), steps(k, (dh, 1))
    vs, ws = steps(v, (1, dh)), steps(w, (dh, 1))
    S = S.reshape(B * H, dh, dh)
    ys = []
    for t in range(T):
        ys.append(torch.bmm(rs[t], S))
        S = torch.baddbmm(S * ws[t], ks[t], vs[t])
    y = torch.cat(ys, dim=1).reshape(B, H, T, dh).transpose(1, 2)
    return y + bonus, S.reshape(B, H, dh, dh)


def rwkv6_apply(p: RWKV6, cfg: ModelConfig, x: torch.Tensor,
                state: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x (B, T, d) -> (y, new state); ``state`` = {"S" (B, H, dh, dh)
    float32, "x_prev" (B, d): the last input of the previous call}, or
    None (zeros, and no state returned)."""
    B, T, d = x.shape
    H = cfg.n_heads
    dh = d // H
    xs = token_shift(x, None if state is None else state["x_prev"])
    mu = p.mu.to(x.dtype)
    xr, xk, xv, xw, xg = (x + (xs - x) * mu[i] for i in range(5))
    r = p.w_r(xr).reshape(B, T, H, dh)
    k = p.w_k(xk).reshape(B, T, H, dh)
    v = p.w_v(xv).reshape(B, T, H, dh)
    g = F.silu(p.w_g(xg))
    wl = p.w_lora_b(torch.tanh(p.w_lora_a(xw)))
    w = torch.exp(-torch.exp(p.w0 + wl.float())).reshape(B, T, H, dh)
    S0 = (torch.zeros((B, H, dh, dh), device=x.device) if state is None
          else state["S"])
    y, S = wkv6(r.float(), k.float(), v.float(), w, p.u, S0)
    y = p.ln_out(y)              # per-head group norm (population variance)
    out = p.w_o(y.reshape(B, T, d).to(x.dtype) * g)
    return out, None if state is None else {"S": S, "x_prev": x[:, -1]}


def rwkv6_state_init(cfg: ModelConfig, batch: int, *, device=None) -> dict:
    """A layer's recurrent state: S zeros (B, H, dh, dh) float32, x_prev
    zeros (B, d)."""
    dh = cfg.d_model // cfg.n_heads
    return {"S": torch.zeros((batch, cfg.n_heads, dh, dh), device=device),
            "x_prev": torch.zeros((batch, cfg.d_model),
                                  dtype=getattr(torch, cfg.dtype),
                                  device=device)}


# --------------------------------------------------------------------------
# GQA attention (full / sliding-window) with optional KV cache
# --------------------------------------------------------------------------

def gqa_init(cfg: ModelConfig, *, seed: Optional[int] = None,
             device=None) -> Attention:
    """An ``Attention`` module, initialised by ``init_weights_`` under
    ``seed`` (left uninitialised without one, e.g. on the ``meta``
    device); serving weights, without gradients."""
    attn = Attention(cfg, device=device).requires_grad_(False)
    if seed is not None:
        init_weights_(attn, seed)
    return attn


@torch.no_grad()
def _draw_normal_(p: torch.Tensor, seed: int, index: int,
                  scale: float) -> None:
    """``p`` <- ``scale`` x N(0, 1) from Philox trial ``index``, in float32
    and then cast (the JAX package's ``normal(...) * scale``), slab by
    slab."""
    flat = p.view(-1)
    tid = torch.tensor([index], dtype=torch.int64, device=p.device)
    for lo in range(0, flat.numel(), INIT_SLAB):
        m = min(INIT_SLAB, flat.numel() - lo)
        z = rng.normal(seed, tid, INIT_STREAM, (m,), start=lo)[0]
        flat[lo:lo + m] = (z * scale).to(p.dtype)


@torch.no_grad()
def init_weights_(module: nn.Module, seed: int,
                  scales: Optional[dict] = None) -> nn.Module:
    """The JAX package's initialisation of every parameter of ``module``,
    device-independent: projections N(0, 1/d_in) (``Dense.init_scale``),
    biases zero, norm scales one and layer-norm biases zero, a module's
    ``INIT_CONST`` (name -> value) and ``INIT_STD`` (name -> standard
    deviation) leaves, and any parameter in ``scales`` (parameter ->
    standard deviation) normal at that scale.  Parameter ``i`` of
    ``named_parameters()`` is drawn from Philox trial ``i``, so each is a
    function of (seed, its index) alone."""
    std = dict(scales or {})
    const = {}
    for m in module.modules():
        if isinstance(m, Dense):
            std[m.w] = m.init_scale
            if m.b is not None:
                const[m.b] = 0.0
        elif isinstance(m, (RMSNorm, LayerNorm)):
            const[m.scale] = 1.0
            if isinstance(m, LayerNorm):
                const[m.bias] = 0.0
        for name, val in getattr(m, "INIT_CONST", {}).items():
            const[getattr(m, name)] = val
        for name, val in getattr(m, "INIT_STD", {}).items():
            std[getattr(m, name)] = val
    for i, (name, p) in enumerate(module.named_parameters()):
        if p in const:
            p.fill_(const[p])
        elif p in std:
            _draw_normal_(p, seed, i, std[p])
        else:
            raise ValueError(f"no initialisation rule for parameter {name}")
    return module


def _records_grad(*ts: torch.Tensor) -> bool:
    """True when autograd records an op on any of ``ts``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def gqa_apply(p: Attention, cfg: ModelConfig, x: torch.Tensor, *,
              window: Optional[int] = None,
              positions: Optional[torch.Tensor] = None,
              cache: Optional[dict] = None, use_rope: bool = True,
              causal: bool = True,
              xattn_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x (B, T, d) -> (y (B, T, d), new_cache).  ``cache`` = {"k", "v"
    (B, K, S, dh), "pos" (int)}; its tensors are written in place.
    ``xattn_kv`` = (k, v) (B, H, T_enc, dh): cross-attention over these
    precomputed keys and values, not causal, without RoPE and without a
    cache write (the cache is returned as given)."""
    B, T, _ = x.shape
    dh, H, K = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    if xattn_kv is not None:
        q = p.wq(x).reshape(B, T, H, dh).transpose(1, 2)
        out = attention_core(q, *xattn_kv, causal=False, q_offset=0)
        return p.wo(out.transpose(1, 2).reshape(B, T, H * dh)), cache
    if window is not None and cfg.attn_logit_softcap:
        raise NotImplementedError(
            "a sliding-window layer with attn_logit_softcap: the JAX ring "
            "path ignores the softcap while attention_core applies it "
            "(ROADMAP.md section 3), so the port takes neither")
    if positions is None:
        positions = torch.arange(T, device=x.device)[None, :]
    q = p.wq(x).reshape(B, T, H, dh)
    kx = p.wk(x).reshape(B, T, K, dh)
    vx = p.wv(x).reshape(B, T, K, dh)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        kx = apply_rope(kx, positions, cfg.rope_theta)
    pos = None if cache is None else cache["pos"]
    S = None if cache is None else cache["k"].shape[2]
    # the ring condition of repro/models/layers.py:374
    ring = cache is not None and window is not None and S < cfg.max_seq_len

    if window is not None and causal and not _records_grad(q, kx, vx) \
            and (cache is None or (ring and pos == 0)):
        # Windowed causal attention over this chunk alone: without a cache,
        # or into an empty ring, where every ring slot holds a negative
        # position and is masked (repro/models/layers.py:374-402 reduces
        # to this, also for T > S).  The kernel takes the (B, T, H, dh)
        # layout as is.  It is forward-only, as the TPU kernel is: under
        # autograd the layer takes attention_core below, the JAX model's
        # own no-cache path (repro/models/layers.py:367-371), which never
        # calls its Pallas kernel.
        out = ops.swa_attention(q.contiguous(), kx.contiguous(),
                                vx.contiguous(), window=window)
        o = out.reshape(B, T, H * dh)
        if ring:
            _ring_write(cache, kx.transpose(1, 2), vx.transpose(1, 2))
            cache = {**cache, "pos": pos + T}
        return p.wo(o), cache

    q = q.transpose(1, 2)                      # (B, H, T, dh)
    kx = kx.transpose(1, 2)
    vx = vx.transpose(1, 2)
    if cache is None:
        out = attention_core(q, repeat_kv(kx, H // K), repeat_kv(vx, H // K),
                             causal=causal, q_offset=0, window=window,
                             softcap=cfg.attn_logit_softcap)
    elif ring:
        # ring buffer of S slots, pos > 0: attend over [pre-write ring |
        # this chunk], then write (repro/models/layers.py:374-402)
        dev = x.device
        slot = torch.arange(S, device=dev)
        qpos = pos + torch.arange(T, device=dev)
        # latest absolute position per ring slot before this chunk
        abs_old = (pos - 1) - torch.remainder(pos - 1 - slot, S)
        k_all = torch.cat([cache["k"], kx], dim=2)
        v_all = torch.cat([cache["v"], vx], dim=2)
        kpos = torch.cat([abs_old, qpos])
        valid = ((kpos[None, :] >= 0) & (kpos[None, :] <= qpos[:, None])
                 & (kpos[None, :] > qpos[:, None] - window))
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                         repeat_kv(k_all, H // K).float()) / math.sqrt(dh)
        s = s.masked_fill(~valid, float("-inf"))
        w_ = torch.softmax(s, dim=-1)
        # a fully masked row gives zeros (repro/models/layers.py:393)
        w_ = torch.where(torch.isfinite(s).any(-1, keepdim=True), w_, 0.0)
        out = torch.einsum("bhqk,bhkd->bhqd", w_.to(x.dtype),
                           repeat_kv(v_all, H // K))
        _ring_write(cache, kx, vx)
        cache = {**cache, "pos": pos + T}
    else:
        if pos + T > S:
            # lax.dynamic_update_slice_in_dim (repro/models/layers.py:414)
            # would clamp the write and corrupt the cache silently
            # (ROADMAP.md section 3)
            raise ValueError(f"KV cache overflow: {pos} + {T} tokens into a "
                             f"cache of {S}")
        cache["k"][:, :, pos:pos + T] = kx
        cache["v"][:, :, pos:pos + T] = vx
        out = attention_core(q, repeat_kv(cache["k"], H // K),
                             repeat_kv(cache["v"], H // K), causal=True,
                             q_offset=pos, window=window, kv_len=pos + T,
                             softcap=cfg.attn_logit_softcap)
        cache = {**cache, "pos": pos + T}
    o = out.transpose(1, 2).reshape(B, T, H * dh)
    return p.wo(o), cache


def _ring_write(cache: dict, kx: torch.Tensor, vx: torch.Tensor) -> None:
    """Write a chunk's keys/values (B, K, T, dh) into the ring in place:
    only the last S tokens persist, at slots (pos + t0 + i) % S
    (repro/models/layers.py:396-397)."""
    S, T, pos = cache["k"].shape[2], kx.shape[2], cache["pos"]
    t0 = max(0, T - S)
    slots = torch.remainder(pos + t0 + torch.arange(T - t0, device=kx.device),
                            S)
    cache["k"][:, :, slots] = kx[:, :, t0:]
    cache["v"][:, :, slots] = vx[:, :, t0:]


def gqa_cache_init(cfg: ModelConfig, batch: int, max_len: int, *,
                   window: Optional[int] = None, device=None) -> dict:
    """A layer's KV cache: S = min(window, max_len) slots for a windowed
    layer (repro/models/layers.py:435; a ring when S < cfg.max_seq_len),
    else max_len."""
    S = min(window, max_len) if window else max_len
    dt = getattr(torch, cfg.dtype)
    shape = (batch, cfg.n_kv_heads, S, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device), "pos": 0}
