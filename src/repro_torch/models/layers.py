"""Layers of the port's LM stack (counterpart of ``repro.models.layers``):
projections, RMS and layer norm, rotary embeddings, the attention core,
grouped-query attention with its KV cache (full or ring buffer) and
cross-attention, DeepSeek's multi-head latent attention (MLA) with its
compressed cache, the SwiGLU and GELU feed-forwards, the capacity-based
mixture of experts (MoE), the RWKV-6 time-mix and channel-mix with their
token shift and recurrent state, and Jamba's Mamba mixer (selective scan)
with its conv and scan state.

Weights keep the JAX layout (a ``dense`` weight is ``(d_in, d_out)`` and is
used as ``x @ w``) and the JAX names, so ``repro_torch.convert.lm_params``
is a copy.  The attention of a sliding-window (``swa``) layer over a chunk
of fresh tokens, with no cache or into an empty ring, is the
``swa_attention`` kernel (``kernels/ops.py``) when no gradient is
recorded; the other attention paths, and that one under autograd, are
torch ops, as the JAX package computes them in jnp.  The RWKV-6
recurrence and Mamba's selective scan are step loops in torch ops, as the
JAX package's are ``lax.scan``s, and the MoE expert products are ``bmm``,
as the JAX package's are ``einsum`` (no Pallas kernel in any of them).  KV
caches are updated in place (the JAX package returns new arrays); ``pos``
is a host integer.

Initialisation (``init_weights_``) is the JAX package's scales drawn from
the port's counter-based Philox (``core/rng.py``): parameter ``i`` of
``named_parameters()`` takes the words of trial ``i``, stream
``INIT_STREAM``, under the model's seed, so the weights are a function of
(config, seed) alone, the same on the card as on the CPU.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core import rng
from ..kernels import ops
from ..sharding import (BOTH, DATA, MODEL, all_reduce, current_mesh_ctx,
                        is_dtensor, matmul_ready, reduce_partial, seq_write,
                        shard, sum_partials, unflatten)
from .config import ModelConfig

__all__ = ["dense", "rms_norm", "layer_norm", "rope_freqs", "apply_rope",
           "attention_core", "gqa_core", "repeat_kv", "gqa_init",
           "gqa_apply", "gqa_cache_init", "swiglu", "gelu_mlp", "token_shift",
           "cmix_apply", "wkv6", "rwkv6_apply", "rwkv6_state_init",
           "Dense", "RMSNorm", "LayerNorm", "make_norm", "Attention",
           "SwiGLU", "GeluMLP", "CMix", "RWKV6", "init_weights_", "MLA",
           "mla_apply", "mla_cache_init", "MoE", "Routing", "moe_capacity",
           "moe_route", "moe_slots", "moe_local", "moe_apply", "Mamba",
           "mamba_a_log", "mamba_conv", "selective_scan", "mamba_apply",
           "mamba_state_init"]

#: the Philox stream of the initial weights, one that no other draw of the
#: port uses (the delay models take 0-4, the processes 5-8, the fault layers
#: 9 and up, the LM data 0-3), so a model's weights share no words with the
#: tokens or delays drawn under the same seed
INIT_STREAM = 0x494E4954
#: words a parameter is drawn in at a time: no index tensor of a whole
#: embedding (671 M elements in gemma3-4b) is ever made
INIT_SLAB = 1 << 24
#: the slab on the CPU: Philox's elementwise ops then stay below PyTorch's
#: parallel grain (32 768 elements) and run on one thread, which other
#: processes on a busy machine cannot stall at thread barriers (the same
#: bits for any slab)
INIT_SLAB_CPU = 1 << 14


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = matmul_ready(x, w) @ w.to(x.dtype)
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
    visible key give zeros.  On DTensors each rank attends over its own
    heads (``_local_heads``)."""
    if is_dtensor(q):
        return _local_heads(attention_core, q, k, v, causal=causal,
                            q_offset=q_offset, window=window, kv_len=kv_len,
                            softcap=softcap, chunk_q=chunk_q,
                            chunk_k=chunk_k)
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


def _local_heads(fn, q: torch.Tensor, *kv: torch.Tensor, **kw):
    """``fn(q, *kv, **kw)`` on DTensors q (B, H, T, dh) and kv (B, Hk, S,
    dh), run by each rank on its block (``local_map``): the batch sharded
    over the mesh axes that shard q's batch, the heads over the axes that
    shard q's heads where every head count divides, everything else
    whole (a sequence-sharded cache is gathered, or exchanged for heads:
    the reference's GSPMD gathers it too, which ``seq_shard_decode``
    avoids).  Each rank's attention is then the plain computation over
    its heads; the output takes the same placements."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    heads = [q.shape[1]] + [t.shape[1] for t in kv]
    target = []
    for i, p in enumerate(q.placements):
        if isinstance(p, Shard) and p.dim == 0:
            target.append(Shard(0))
        elif isinstance(p, Shard) and p.dim == 1 and all(
                h % mesh.size(i) == 0 for h in heads):
            target.append(Shard(1))
        else:
            target.append(Replicate())
    return local_map(lambda *ts: fn(*ts, **kw), out_placements=target,
                     in_placements=(target,) * (1 + len(kv)),
                     device_mesh=mesh, redistribute_inputs=True)(q, *kv)


def repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, K, T, dh) -> (B, K * groups, T, dh): query head h reads KV head
    h // groups."""
    if groups == 1:
        return x
    B, K, T, dh = x.shape
    return x[:, :, None].expand(B, K, groups, T, dh).reshape(
        B, K * groups, T, dh)


def _kv_per_rank(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k / v (B, K, S, dh) as ``_local_heads`` should hand them to the
    ranks that share q's heads (DTensors): with fewer KV heads than those
    m ranks (K | m), each KV head m / K times, so that each rank receives
    the one KV head its query heads read (h // G kept) and nothing more;
    else as they are (whole KV groups a rank, or heads not sharded).  The
    rest of GQA's repetition is each rank's, on its own block: the
    exchange never carries a repeated copy beyond that."""
    from torch.distributed.tensor import Shard
    m = 1
    for i, p in enumerate(q.placements):
        if isinstance(p, Shard) and p.dim == 1:
            m *= q.device_mesh.size(i)
    K = k.shape[1]
    if K % m and m % K == 0 and q.shape[1] % m == 0:
        return repeat_kv(k, m // K), repeat_kv(v, m // K)
    return k, v


def gqa_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             **kw) -> torch.Tensor:
    """``attention_core`` over GQA's KV heads: q (B, H, T, dh), k / v (B,
    K, S, dh) repeated to H heads.  On DTensors the repetition is each
    rank's, after the KV heads reach the ranks of their query heads
    (``_kv_per_rank``): a sequence-sharded cache is exchanged as it is
    stored, not H / K times over."""
    if is_dtensor(q):
        return _local_heads(gqa_core, q, *_kv_per_rank(q, k, v), **kw)
    G = q.shape[1] // k.shape[1]
    return attention_core(q, repeat_kv(k, G), repeat_kv(v, G), **kw)


def _shard_attn_act(cfg: ModelConfig, x: torch.Tensor,
                    note: str) -> torch.Tensor:
    """(B, T, H, dh) activation sharding: heads on the model axis when
    divisible; with cfg.attn_batch_shard_fallback, batch over
    (data x model) instead of replicating (§Perf variant for archs whose
    head count is smaller than the model axis, e.g. gemma3's 8 heads)."""
    ctx = current_mesh_ctx()
    if (ctx is not None and cfg.attn_batch_shard_fallback
            and x.shape[2] % ctx.model_size != 0
            and x.shape[0] % (ctx.data_size * ctx.model_size) == 0):
        return shard(x, BOTH, None, None, None, note=note)
    return shard(x, DATA, None, MODEL, None, note=note)


def grouped_attention(q: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor,
                      *, kv_len: int, q_offset: int) -> torch.Tensor:
    """Decode attention without ``repeat_kv`` (repro/models/layers.py:
    234-251): q (B, H, T, dh), the cache kf / vf (B, K, S, dh) read as
    they are, scores grouped by KV head (query head h reads KV head h //
    G): products of the activation dtype summed in float32, keys at
    positions >= ``kv_len`` or past the query masked, then the softmax's
    weights in the cache's dtype against vf.  On DTensors each rank
    attends over its own KV heads and their query groups
    (``_local_heads``), the cache brought to them by ``_kv_per_rank``."""
    if is_dtensor(q):
        return _local_heads(grouped_attention, q, *_kv_per_rank(q, kf, vf),
                            kv_len=kv_len, q_offset=q_offset)
    B, H, T, dh = q.shape
    K, S = kf.shape[1], kf.shape[2]
    G = H // K
    qg = unflatten(q, 1, (K, G))
    s = torch.einsum("bkgtd,bksd->bkgts", qg.float(), kf.float()) \
        / math.sqrt(dh)
    kpos = torch.arange(S, device=q.device)
    qpos = q_offset + torch.arange(T, device=q.device)
    ok = (kpos[None, :] < kv_len) & (kpos[None, :] <= qpos[:, None])
    p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
    out = torch.einsum("bkgts,bksd->bkgtd", p.to(vf.dtype), vf)
    return out.reshape(B, H, T, dh)


def seq_sharded_decode_attention(cfg: ModelConfig, q: torch.Tensor,
                                 kx: torch.Tensor, vx: torch.Tensor,
                                 cache: dict
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Single-token decode against a KV cache whose SEQUENCE dim is sharded
    over the model axis (§Perf 'ringdecode', repro/models/layers.py:
    254-310): each shard writes the new key and value into its slice if
    it owns the position, takes a local flash partial over its slice, and
    the global softmax is assembled with one max and two sum all-reduces
    over the model axis of (B, K, G)- and (B, K, G, dh)-sized float32
    tensors, instead of gathering the cache.  ``local_map`` is the
    reference's ``shard_map``; the reductions are float32, as the
    reference's are (``all_reduce``).

    q (B, H, 1, dh); kx / vx (B, K, 1, dh); cache {k, v (B, K, S, dh),
    pos}, DTensors.  Returns (out (B, H, 1, dh), k, v): the cache written
    in place when its sequence is already sharded over the model axis,
    else (heads sharded, as ``cache_shardings`` gives a model axis that
    divides K) resharded by sequence, as the reference's ``out_specs``
    leave it."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    ctx = current_mesh_ctx()
    mesh = ctx.mesh
    B, H, _, dh = q.shape
    K = kx.shape[1]
    G = H // K
    pos = cache["pos"]
    names = list(mesh.mesh_dim_names)
    mdim = names.index(ctx.model_axis)
    group = mesh.get_group(ctx.model_axis)
    batch_sharded = ctx.data_size > 1 and B % ctx.data_size == 0
    act = [Shard(0) if batch_sharded and n in ctx.data_axes else Replicate()
           for n in names]
    kv = list(act)
    kv[mdim] = Shard(2)
    scale = 1.0 / math.sqrt(dh)

    def block(q_l, kx_l, vx_l, ck, cv):
        Bl, Sl = q_l.shape[0], ck.shape[2]
        o = mesh.get_local_rank(ctx.model_axis) * Sl
        if o <= pos < o + Sl:
            ck[:, :, pos - o] = kx_l[:, :, 0]
            cv[:, :, pos - o] = vx_l[:, :, 0]
        valid = o + torch.arange(Sl, device=ck.device) <= pos
        qg = q_l.reshape(Bl, K, G, dh)
        s = torch.einsum("bkgd,bksd->bkgs", qg.float(), ck.float()) * scale
        s = s.masked_fill(~valid, float("-inf"))
        m_glob = all_reduce(s.amax(-1), "max", group)
        p = torch.exp(s - m_glob[..., None]).masked_fill(~valid, 0.0)
        l_glob = all_reduce(p.sum(-1), "sum", group)
        o_part = torch.einsum("bkgs,bksd->bkgd", p.to(cv.dtype), cv)
        o_full = all_reduce(o_part.float(), "sum", group)
        out = (o_full / l_glob.clamp_min(1e-30)[..., None]).to(q_l.dtype)
        return out.reshape(Bl, H, 1, dh), ck, cv

    return local_map(block, out_placements=(act, kv, kv),
                     in_placements=(act, act, act, kv, kv),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, kx, vx, cache["k"], cache["v"])


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
    """``w_down(silu(w_gate x) * w_up x)``, of width ``d_ff`` (default
    ``cfg.d_ff``; an MoE layer's shared experts take their own)."""

    def __init__(self, cfg: ModelConfig, *, d_ff: Optional[int] = None,
                 device=None):
        super().__init__()
        d_ff = d_ff or cfg.d_ff
        kw = dict(dtype=getattr(torch, cfg.param_dtype), device=device)
        self.w_gate = Dense(cfg.d_model, d_ff, **kw)
        self.w_up = Dense(cfg.d_model, d_ff, **kw)
        self.w_down = Dense(d_ff, cfg.d_model, scale=1.0 / math.sqrt(d_ff),
                            **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu(self, x)


def swiglu(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(p.w_gate(x)) * p.w_up(x)
    return p.w_down(shard(h, DATA, None, MODEL, note="ffn.h"))


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
    h = F.gelu(p.w_up(x), approximate="tanh")
    return p.w_down(shard(h, DATA, None, MODEL, note="ffn.h"))


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
    k = shard(k, DATA, None, MODEL, note="cmix.h")
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
    r = unflatten(p.w_r(xr), -1, (H, dh))
    k = unflatten(p.w_k(xk), -1, (H, dh))
    v = unflatten(p.w_v(xv), -1, (H, dh))
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
# Mamba (Jamba's selective-scan mixer): causal conv, step loop over time
# --------------------------------------------------------------------------

def mamba_a_log(shape) -> torch.Tensor:
    """Mamba's initial ``A_log`` (di, N): log(1..N) on every row, taken in
    float64 on the CPU and rounded to float32, so the same bits on every
    device.  The reference's jitted ``init_params`` folds the constant to
    these values; its eager ``mamba_init`` gives log 7 one unit in the last
    place higher (XLA's CPU logf; ROADMAP.md section 3)."""
    n = torch.arange(1, shape[-1] + 1, dtype=torch.float64)
    return torch.log(n).float().expand(shape)


class Mamba(nn.Module):
    """Jamba's Mamba mixer (``mamba_init``): ``in_proj`` (d, 2 di) to the
    scan's input and its gate, the causal depthwise conv ``conv_w`` (d_conv,
    di) and ``conv_b``, ``x_proj`` (di, dt_rank + 2 N) to the step size's
    low-rank input and the input-dependent B and C, ``dt_proj`` (dt_rank,
    di) with a bias, ``A_log`` (di, N) and ``D`` (di), both float32 in
    every model, and ``out_proj`` (di, d) at scale 1/sqrt(di), with dt_rank
    = ceil(d / 16); ``forward`` is ``mamba_apply``.  ``A_log`` starts at
    log(1..N) on every row (``INIT_FIXED``), ``D`` at one, ``conv_w``
    N(0, 1/d_conv)."""

    INIT_CONST = {"conv_b": 0.0, "D": 1.0}
    INIT_FIXED = {"A_log": mamba_a_log}

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        d, di, N = cfg.d_model, cfg.d_inner, cfg.d_state
        dt_rank = max(1, math.ceil(d / 16))
        f32 = dict(dtype=torch.float32, device=device)
        kw = dict(dtype=getattr(torch, cfg.param_dtype), device=device)
        self.in_proj = Dense(d, 2 * di, **kw)
        self.conv_w = nn.Parameter(torch.empty((cfg.d_conv, di), **kw))
        self.conv_b = nn.Parameter(torch.empty((di,), **kw))
        self.x_proj = Dense(di, dt_rank + 2 * N, **kw)
        self.dt_proj = Dense(dt_rank, di, bias=True, **kw)
        self.A_log = nn.Parameter(torch.empty((di, N), **f32))
        self.D = nn.Parameter(torch.empty((di,), **f32))
        self.out_proj = Dense(di, d, scale=1.0 / math.sqrt(di), **kw)
        self.INIT_STD = {"conv_w": 1.0 / math.sqrt(cfg.d_conv)}

    def forward(self, x, **kw):
        return mamba_apply(self, self.cfg, x, **kw)


def mamba_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               prev: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The causal depthwise conv over x (B, T, di) with kernel w (d_conv,
    di) and bias b, continuing from ``prev`` (B, d_conv - 1, di), the last
    inputs of the previous call (zeros when None): the reference's left
    fold ``sum(xp[:, i:i + T] * w[i])`` over the d_conv taps in the
    activation dtype, plus ``b`` (``F.conv1d`` would accumulate in another
    order on the card).  Returns (out, the next call's ``prev``)."""
    B, T, di = x.shape
    dconv = w.shape[0]
    if prev is None:
        prev = x.new_zeros((B, dconv - 1, di))
    xp = torch.cat([prev, x], dim=1)
    w = w.to(x.dtype)
    out = xp[:, :T] * w[0]
    for i in range(1, dconv):
        out = out + xp[:, i:i + T] * w[i]
    new_prev = xp[:, T:].clone() if dconv > 1 else prev
    return out + b.to(x.dtype), new_prev


def selective_scan(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
                   h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba's recurrence in float32.  a, bx (B, T, di, N), c (B, T, N), h
    (B, di, N); returns (y (B, T, di), h after the last token).  Per token,
    as the JAX package's ``lax.scan`` step:

        h <- a_t h + bx_t,   y_t = h c_t

    two launches a token (``addcmul``, ``bmm``), with nothing read back to
    the host.  y's sum over N runs in ``bmm``'s order, not XLA's."""
    cs = c.unsqueeze(-1)                            # (B, T, N, 1)
    ys = []
    for t in range(a.shape[1]):
        h = torch.addcmul(bx[:, t], a[:, t], h)
        ys.append(torch.bmm(h, cs[:, t]))
    return torch.cat(ys, dim=-1).transpose(1, 2), h


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(-|x|)), in x's dtype (``F.softplus`` returns x itself above
    its threshold of 20)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def mamba_apply(p: Mamba, cfg: ModelConfig, x: torch.Tensor,
                state: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x (B, T, d) -> (y, new state); ``state`` = {"h" (B, di, N) float32,
    "conv" (B, d_conv - 1, di) in the activation dtype}, or None (zeros,
    and no state returned).  The dtypes follow the reference step by step
    (repro/models/layers.py:770-808): the step size ``delta`` (softplus of
    ``dt_proj``) and ``delta x`` in the activation dtype, the decay
    ``exp(delta A)`` and the input ``delta x B`` in float32, y cast back to
    the activation dtype before the skip ``x D`` and the gate
    ``silu(z)``."""
    N = cfg.d_state
    dt_rank = p.dt_proj.w.shape[0]
    x1, z = p.in_proj(x).chunk(2, dim=-1)
    x1 = shard(x1, DATA, None, MODEL, note="mamba.x")
    x1, conv_new = mamba_conv(x1, p.conv_w, p.conv_b,
                              None if state is None else state["conv"])
    x1 = F.silu(x1)
    dt_, Bm, Cm = p.x_proj(x1).split([dt_rank, N, N], dim=-1)
    delta = _softplus(p.dt_proj(dt_))                     # (B, T, di)
    A = -torch.exp(p.A_log)                               # (di, N) float32
    a = torch.exp(delta.float()[..., None] * A)           # (B, T, di, N)
    bx = (delta * x1).float()[..., None] * Bm.float()[:, :, None, :]
    h0 = (x.new_zeros((x.shape[0],) + tuple(A.shape), dtype=torch.float32)
          if state is None else state["h"])
    y, h = selective_scan(a, bx, Cm.float(), h0)
    y = y.to(x.dtype) + x1 * p.D.to(x.dtype)
    out = p.out_proj(y * F.silu(z))
    return out, None if state is None else {"h": h, "conv": conv_new}


def mamba_state_init(cfg: ModelConfig, batch: int, *, device=None) -> dict:
    """A Mamba layer's state: h zeros (B, di, N) float32, conv zeros (B,
    d_conv - 1, di) in the activation dtype."""
    return {"h": torch.zeros((batch, cfg.d_inner, cfg.d_state),
                             device=device),
            "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner),
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
    slab = INIT_SLAB_CPU if p.device.type == "cpu" else INIT_SLAB
    for lo in range(0, flat.numel(), slab):
        m = min(slab, flat.numel() - lo)
        z = rng.normal(seed, tid, INIT_STREAM, (m,), start=lo)[0]
        flat[lo:lo + m] = (z * scale).to(p.dtype)


@torch.no_grad()
def init_weights_(module: nn.Module, seed: int,
                  scales: Optional[dict] = None) -> nn.Module:
    """The JAX package's initialisation of every parameter of ``module``,
    device-independent: projections N(0, 1/d_in) (``Dense.init_scale``),
    biases zero, norm scales one and layer-norm biases zero, a module's
    ``INIT_CONST`` (name -> value), ``INIT_STD`` (name -> standard
    deviation) and ``INIT_FIXED`` (name -> function of the shape giving
    the leaf's deterministic values as a CPU tensor) leaves, and any
    parameter in ``scales`` (parameter -> standard deviation) normal at
    that scale.  Parameter ``i`` of ``named_parameters()`` is drawn from
    Philox trial ``i``, so each is a function of (seed, its index)
    alone."""
    std = dict(scales or {})
    const, fixed = {}, {}
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
        for name, fn in getattr(m, "INIT_FIXED", {}).items():
            fixed[getattr(m, name)] = fn
    for i, (name, p) in enumerate(module.named_parameters()):
        if p in const:
            p.fill_(const[p])
        elif p in fixed:
            p.copy_(fixed[p](tuple(p.shape)))
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
        q = _shard_attn_act(cfg, unflatten(p.wq(x), -1, (H, dh)), "attn.q")
        out = attention_core(q.transpose(1, 2), *xattn_kv, causal=False,
                             q_offset=0)
        return _attn_out(p, out.transpose(1, 2).reshape(B, T, H * dh)), \
            cache
    if window is not None and cfg.attn_logit_softcap:
        raise NotImplementedError(
            "a sliding-window layer with attn_logit_softcap: the JAX ring "
            "path ignores the softcap while attention_core applies it "
            "(ROADMAP.md section 3), so the port takes neither")
    if positions is None:
        positions = torch.arange(T, device=x.device)[None, :]
    q = _shard_attn_act(cfg, unflatten(p.wq(x), -1, (H, dh)), "attn.q")
    kx = unflatten(p.wk(x), -1, (K, dh))
    vx = unflatten(p.wv(x), -1, (K, dh))
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
        return _attn_out(p, o), cache

    q = q.transpose(1, 2)                      # (B, H, T, dh)
    kx = kx.transpose(1, 2)
    vx = vx.transpose(1, 2)
    if cache is None:
        out = gqa_core(q, kx, vx, causal=causal, q_offset=0, window=window,
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
        ctx = current_mesh_ctx()
        if (cfg.seq_shard_decode and T == 1 and window is None
                and cfg.attn_logit_softcap is None and ctx is not None
                and ctx.model_size > 1 and S % ctx.model_size == 0
                and is_dtensor(cache["k"])):
            out, kf, vf = seq_sharded_decode_attention(cfg, q, kx, vx, cache)
            cache = {**cache, "k": kf, "v": vf}
        else:
            seq_write(cache["k"], kx, pos, 2)
            seq_write(cache["v"], vx, pos, 2)
            if cfg.grouped_gqa and window is None \
                    and cfg.attn_logit_softcap is None:
                out = grouped_attention(q, cache["k"], cache["v"],
                                        kv_len=pos + T, q_offset=pos)
            else:
                out = gqa_core(q, cache["k"], cache["v"], causal=True,
                               q_offset=pos, window=window, kv_len=pos + T,
                               softcap=cfg.attn_logit_softcap)
        cache = {**cache, "pos": pos + T}
    o = out.transpose(1, 2).reshape(B, T, H * dh)
    return _attn_out(p, o), cache


def _attn_out(p: Attention, o: torch.Tensor) -> torch.Tensor:
    """``wo`` of the heads' output (B, T, H dh), its batch on the data axes
    and the rest replicated first (the reference's "attn.o")."""
    return p.wo(shard(o, DATA, None, None, note="attn.o"))


def _ring_write(cache: dict, kx: torch.Tensor, vx: torch.Tensor) -> None:
    """Write a chunk's keys/values (B, K, T, dh) into the ring in place:
    only the last S tokens persist, at slots (pos + t0 + i) % S
    (repro/models/layers.py:396-397), at most two runs of slots."""
    S, T, pos = cache["k"].shape[2], kx.shape[2], cache["pos"]
    t0 = max(0, T - S)
    first = (pos + t0) % S            # slots first .. S - 1, then 0 ..
    n1 = min(S - first, T - t0)
    for lo, hi, slot in ((t0, t0 + n1, first), (t0 + n1, T, 0)):
        if lo < hi:
            seq_write(cache["k"], kx[:, :, lo:hi], slot, 2)
            seq_write(cache["v"], vx[:, :, lo:hi], slot, 2)


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


# --------------------------------------------------------------------------
# MLA: DeepSeek-V3 multi-head latent attention (compressed KV cache)
# --------------------------------------------------------------------------

class MLA(nn.Module):
    """Multi-head latent attention's projections (``mla_init``): the
    query's low-rank pair ``w_dq``/``q_norm``/``w_uq`` (``w_uq`` alone
    without ``q_lora_rank``), the key/value compression ``w_dkv`` with
    ``kv_norm``, its decompression ``w_uk`` (the nope keys and the values
    of every head), the shared rotary key ``w_kr`` and ``wo``;
    ``forward`` is ``mla_apply``."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        H, R, d = cfg.n_heads, cfg.kv_lora_rank, cfg.d_model
        nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        kw = dict(dtype=getattr(torch, cfg.param_dtype), device=device)
        self.w_dkv = Dense(d, R, **kw)
        self.kv_norm = RMSNorm(R, cfg.norm_eps, **kw)
        self.w_uk = Dense(R, H * (nd + vd), **kw)
        self.w_kr = Dense(d, rd, **kw)
        self.wo = Dense(H * vd, d, **kw)
        if cfg.q_lora_rank:
            self.w_dq = Dense(d, cfg.q_lora_rank, **kw)
            self.q_norm = RMSNorm(cfg.q_lora_rank, cfg.norm_eps, **kw)
            self.w_uq = Dense(cfg.q_lora_rank, H * (nd + rd), **kw)
        else:
            self.w_dq = self.q_norm = None
            self.w_uq = Dense(d, H * (nd + rd), **kw)

    def forward(self, x, **kw):
        return mla_apply(self, self.cfg, x, **kw)


def mla_apply(p: MLA, cfg: ModelConfig, x: torch.Tensor, *,
              positions: Optional[torch.Tensor] = None,
              cache: Optional[dict] = None
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x (B, T, d) -> (y (B, T, d), new_cache).  ``cache`` = {"c_kv" (B, S,
    R), "k_rope" (B, S, rd), "pos" (int)}, written in place.  The naive
    path decompresses the latents of positions [0, pos + T) through
    ``w_uk`` (the reference decompresses all S and masks those past pos +
    T: the same numbers) and attends with q/k heads of nd + rd and value
    heads of vd; with ``cfg.mla_absorb`` and a cache, the scores are taken
    in the latent space in float32 and the context is projected out
    through ``w_uk``'s value half (repro/models/layers.py:500-525)."""
    B, T, _ = x.shape
    H = cfg.n_heads
    nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    if positions is None:
        positions = torch.arange(T, device=x.device)[None, :]
    ql = x if p.w_dq is None else p.q_norm(p.w_dq(x))
    q = unflatten(p.w_uq(ql), -1, (H, nd + rd))
    q = shard(q, DATA, None, MODEL, None, note="mla.q")
    q_nope = q[..., :nd]
    q_rope = apply_rope(q[..., nd:], positions, cfg.rope_theta)
    c_kv = p.kv_norm(p.w_dkv(x))                             # (B, T, R)
    k_rope = apply_rope(p.w_kr(x), positions, cfg.rope_theta)  # (B, T, rd)
    if cache is None:
        q_offset, new_cache = 0, None
    else:
        pos, S = cache["pos"], cache["c_kv"].shape[1]
        if pos + T > S:
            # the reference's dynamic_update_slice would clamp the write
            # (ROADMAP.md section 3)
            raise ValueError(f"MLA cache overflow: {pos} + {T} tokens into "
                             f"a cache of {S}")
        seq_write(cache["c_kv"], c_kv, pos, 1)
        seq_write(cache["k_rope"], k_rope, pos, 1)
        c_kv = cache["c_kv"][:, :pos + T]
        k_rope = cache["k_rope"][:, :pos + T]
        q_offset, new_cache = pos, {**cache, "pos": pos + T}
    S_ = c_kv.shape[1]

    if cfg.mla_absorb and cache is not None:
        R = cfg.kv_lora_rank
        wk = p.w_uk.w.to(x.dtype).reshape(R, H, nd + vd)
        w_uk_k, w_uk_v = wk[..., :nd], wk[..., nd:]
        q_lat = torch.einsum("bthn,rhn->bthr", q_nope, w_uk_k)
        # preferred_element_type=float32: products of the activation dtype
        # summed in float32
        s = torch.einsum("bthr,bsr->bhts", q_lat.float(), c_kv.float())
        s = s + torch.einsum("bthr,bsr->bhts", q_rope.float(),
                             k_rope.float())
        s = s / math.sqrt(nd + rd)
        qpos = q_offset + torch.arange(T, device=x.device)
        seen = torch.arange(S_, device=x.device)[None, :] <= qpos[:, None]
        pr = torch.softmax(s.masked_fill(~seen, float("-inf")), dim=-1)
        ctx = torch.einsum("bhts,bsr->bthr", pr.to(x.dtype), c_kv)
        out_h = torch.einsum("bthr,rhv->bthv", ctx, w_uk_v)
        o = shard(out_h.reshape(B, T, H * vd), DATA, None, None,
                  note="mla.o")
        return p.wo(o), new_cache

    kv = unflatten(p.w_uk(c_kv), -1, (H, nd + vd))
    k = torch.cat([kv[..., :nd],
                   k_rope[:, :, None, :].expand(B, S_, H, rd)], dim=-1)
    qh = torch.cat([q_nope, q_rope], dim=-1).transpose(1, 2)
    out = attention_core(qh, k.transpose(1, 2), kv[..., nd:].transpose(1, 2),
                         causal=True, q_offset=q_offset,
                         kv_len=None if cache is None else q_offset + T)
    o = shard(out.transpose(1, 2).reshape(B, T, H * vd), DATA, None, None,
              note="mla.o")
    return p.wo(o), new_cache


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int, *,
                   device=None) -> dict:
    """An MLA layer's cache: the latents ``c_kv`` (B, S, R) and the shared
    rotary keys ``k_rope`` (B, S, rd), zeros of the activation dtype."""
    dt = getattr(torch, cfg.dtype)
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                dtype=dt, device=device),
            "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                  dtype=dt, device=device),
            "pos": 0}


# --------------------------------------------------------------------------
# MoE: capacity-based grouped GEMM
# --------------------------------------------------------------------------

class MoE(nn.Module):
    """Routed experts with a float32 ``router`` (d, E), the experts'
    ``w_gate``/``w_up`` (E, d, f) and ``w_down`` (E, f, d), and the
    ``shared`` experts as one SwiGLU of width f x n_shared_experts
    (``moe_init``); ``forward`` is ``moe_apply``."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        E, d = cfg.n_experts, cfg.d_model
        f = cfg.d_ff_expert or cfg.d_ff
        kw = dict(dtype=getattr(torch, cfg.param_dtype), device=device)
        # the router stays float32 in every model, for a stable top-k
        self.router = nn.Parameter(torch.empty((d, E), dtype=torch.float32,
                                               device=device))
        self.w_gate = nn.Parameter(torch.empty((E, d, f), **kw))
        self.w_up = nn.Parameter(torch.empty((E, d, f), **kw))
        self.w_down = nn.Parameter(torch.empty((E, f, d), **kw))
        self.shared = (SwiGLU(cfg, d_ff=f * cfg.n_shared_experts,
                              device=device)
                       if cfg.n_shared_experts else None)
        s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
        self.INIT_STD = {"router": s_in, "w_gate": s_in, "w_up": s_in,
                         "w_down": s_out}

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return moe_apply(self, self.cfg, x)


class Routing(NamedTuple):
    """One call's routing (``moe_route``); the pair arrays run over the T x
    K (token, k) pairs in the stable order of their local expert."""
    top_w: torch.Tensor     # (T, K) float32 gate weights, renormalised
    top_i: torch.Tensor     # (T, K) int64 experts, best first
    aux: torch.Tensor       # () float32 load-balance loss E sum f_e P_e
    order: torch.Tensor     # (T K,) the pairs sorted by expert
    slot: torch.Tensor      # (T K,) buffer row e C + c, E C if dropped
    ok: torch.Tensor        # (T K,) bool, kept within capacity
    counts: torch.Tensor    # (E,) pairs per expert
    capacity: int           # C


def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    """C = max(1, ceil(T K / E x capacity_factor)) for the T tokens of one
    call, in Python floats as the reference computes it."""
    return max(1, math.ceil(tokens * cfg.experts_per_token / cfg.n_experts
                            * cfg.capacity_factor))


def moe_route(x2d: torch.Tensor, router_w: torch.Tensor,
              cfg: ModelConfig) -> Routing:
    """The reference's routing (repro/models/layers.py:648-668) over all E
    experts on one device: softmax of the float32 logits,
    the top K (the lower expert first among equal probabilities, as
    ``lax.top_k`` orders them: a stable descending sort, since
    ``torch.topk`` promises no order for ties), weights renormalised by
    max(sum, 1e-9), the aux loss, and a stable sort of the pairs by
    expert whose first C of each expert are kept.  Counts are integer
    scatter-adds: exact, and no host synchronisation."""
    T = x2d.shape[0]
    E, K = cfg.n_experts, cfg.experts_per_token
    C = moe_capacity(cfg, T)
    probs = torch.softmax(x2d.float() @ router_w.float(), dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = srt.values[:, :K], srt.indices[:, :K]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    order, slot, ok, counts = moe_slots(top_i, E, C)
    f_e = counts.float() / (T * K)
    # jnp.mean multiplies the sum by the float32 reciprocal of the count
    P_e = probs.sum(0) * (1.0 / T)
    aux = E * (f_e * P_e).sum()
    return Routing(top_w, top_i, aux, order, slot, ok, counts, C)


def moe_slots(top_i: torch.Tensor, n_experts: int, capacity: int
              ) -> Tuple[torch.Tensor, ...]:
    """The dispatch plan of the top-K picks ``top_i`` (T, K): a stable sort
    of the T K pairs by expert, whose first ``capacity`` C of each expert
    are kept.  Returns (order, slot: e C + c, or E C where dropped, ok,
    counts per expert)."""
    flat_i = top_i.reshape(-1)
    skey, order = torch.sort(flat_i, stable=True)
    counts = torch.zeros(n_experts, dtype=torch.int64,
                         device=top_i.device).scatter_add_(
                             0, skey, torch.ones_like(skey))
    starts = counts.cumsum(0) - counts                      # exclusive
    pos = torch.arange(flat_i.numel(), device=top_i.device) - starts[skey]
    ok = pos < capacity
    slot = torch.where(ok, skey * capacity + pos, n_experts * capacity)
    return order, slot, ok, counts


def moe_local(x2d: torch.Tensor, router_w: torch.Tensor,
              w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
              *, cfg: ModelConfig, e_start: int = 0,
              n_local: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_moe_local`` (repro/models/layers.py:639-681) over the ``n_local``
    experts from ``e_start`` (default: all E), whose weights ``w_gate`` /
    ``w_up`` (n_local, d, f) and ``w_down`` (n_local, f, d) are given: x2d
    (T, d) -> (those experts' contributions (T, d), aux).  Routing and
    capacity are the reference's over all E experts for these T tokens
    (``moe_route``: every rank of an expert-parallel group routes alike),
    and the aux loss is the whole estimate, as the reference's local one
    is.  A local expert's kept pairs are those the one-device plan keeps,
    in the same order: the reference sorts by local expert with the other
    experts' pairs last, the same stable order restricted to its experts.
    Dispatch gathers the (n_local, C, d) expert buffer: row (e, c) holds
    the token of local expert e's c-th kept pair, or zeros, so only kept
    pairs are written (the reference's trash row is an artefact of its
    scatter).  The expert products are ``bmm`` in the activation dtype.
    Combine gathers each (token, k) pair's output back into (T, K, d)
    order (zero for a pair of another rank's expert or one dropped),
    scales it by its gate weight cast to the activation dtype and sums
    over K: no float atomics, so a recomputation (remat) gives the same
    numbers."""
    T, d = x2d.shape
    K = cfg.experts_per_token
    n_local = cfg.n_experts if n_local is None else n_local
    rt = moe_route(x2d, router_w, cfg)
    C, dev = rt.capacity, x2d.device
    c = torch.arange(C, device=dev)
    counts = rt.counts[e_start:e_start + n_local]
    starts = (rt.counts.cumsum(0) - rt.counts)[e_start:e_start + n_local]
    src = (starts[:, None] + c[None, :]).clamp(max=T * K - 1)
    tok = torch.where(c[None, :] < counts[:, None],
                      rt.order[src] // K, T)                 # T: zero row
    xz = torch.cat([x2d, x2d.new_zeros((1, d))])
    eb = xz[tok]                                            # (n_local, C, d)
    h = torch.bmm(eb, w_gate.to(eb.dtype))
    u = torch.bmm(eb, w_up.to(eb.dtype))
    y = torch.bmm(F.silu(h) * u, w_down.to(eb.dtype))
    yz = torch.cat([y.reshape(n_local * C, d), y.new_zeros((1, d))])
    # each pair's row in original (token, k) order: the sort's inverse
    # permutation (a scatter to distinct indices), then its row among the
    # local experts' (n_local C: the zero row)
    slot = torch.empty_like(rt.slot).scatter_(0, rt.order, rt.slot)
    slot = slot - e_start * C
    slot = torch.where((slot >= 0) & (slot < n_local * C), slot,
                       n_local * C)
    contrib = yz[slot] * rt.top_w.reshape(-1, 1).to(x2d.dtype)
    return contrib.reshape(T, K, d).sum(1), rt.aux


def moe_apply(p: MoE, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, d) -> (out, aux_loss): the routed experts over the B T
    tokens of this call plus the shared experts (dense, tensor-parallel
    under a mesh).  Under a mesh context whose model axis divides E, the
    experts are expert-parallel over it (repro/models/layers.py:684-724,
    ``local_map`` for ``shard_map``): each rank runs ``moe_local`` over its
    E / model_size experts on its data shard's tokens (all tokens when
    the data size does not divide them), the outputs are summed over the
    model axis, and the aux is summed over every axis and divided by the
    data size, as the reference's is: each model rank holds the whole
    estimate, so it is model_size times the one-device aux (ROADMAP.md
    section 3), and its gradient is model_size times the one-device aux's
    (``_moe_mesh`` says where each gradient is reduced).  Other meshes run
    every expert on replicated tokens, the reference's GSPMD fallback."""
    B, T, d = x.shape
    x2 = x.reshape(B * T, d)
    ctx = current_mesh_ctx()
    if ctx is None or not is_dtensor(x2):
        out, aux = moe_local(x2, p.router, p.w_gate, p.w_up, p.w_down,
                             cfg=cfg)
    else:
        out, aux = _moe_mesh(p, cfg, x2, ctx)
    out = out.reshape(B, T, d)
    if p.shared is not None:
        out = out + reduce_partial(swiglu(p.shared, x))
    return out, aux


def _moe_mesh(p: MoE, cfg: ModelConfig, x2: torch.Tensor, ctx):
    """``moe_apply``'s routed experts under a mesh, in ``local_map``.

    Where each gradient is reduced.  The forward's sums over the model
    axis (the outputs, the aux) and, where the tokens are sharded, over
    the data axes (the aux) are ``sum_partials``: each rank's gradient of
    a sum is the replicated output gradient as it is, no collective.  The
    block's gradients are then per-rank partials, which ``local_map``
    hands back as such (``in_grad_placements``): DTensor reduces the
    tokens' where the layers below read it, as it reduces a
    column-parallel product's, and the train step reduces the weights'
    once before the optimizer reads them.  The tokens' gradient is
    ``Partial`` over the model axis (each rank's
    experts' share and its copy of the routing's), the router's over the
    model axis and, with the tokens sharded, over the data axes (each
    data shard's tokens), the expert stacks' over the data axes with the
    tokens sharded.  Without expert parallelism every gradient lies as
    its input does."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = ctx.mesh
    names = list(mesh.mesh_dim_names)
    E = cfg.n_experts
    msize = ctx.model_size
    expert_parallel = msize > 1 and E % msize == 0
    n_local = E // msize if expert_parallel else E
    tokens_sharded = (expert_parallel and ctx.data_size > 1
                      and x2.shape[0] % ctx.data_size == 0)

    def lay(on_model, on_data):
        return [on_model if n == ctx.model_axis else
                on_data if n in ctx.data_axes else Replicate() for n in names]

    rep = [Replicate()] * len(names)
    data_tok = Shard(0) if tokens_sharded else Replicate()
    tok = lay(Replicate(), data_tok)
    wts = lay(Shard(0), Replicate()) if expert_parallel else rep
    in_pl = (tok, rep, wts, wts, wts)
    if expert_parallel:
        data_sum = Partial() if tokens_sharded else Replicate()
        wts_g = lay(Shard(0), data_sum)
        in_grad = (lay(Partial(), data_tok), lay(Partial(), data_sum),
                   wts_g, wts_g, wts_g)
    else:
        in_grad = in_pl
    model_group = [mesh.get_group(ctx.model_axis)] if expert_parallel else []
    # the reference's psum of the aux over every axis; with the tokens
    # replicated over the data axes their sum over the data size is the
    # aux itself
    aux_groups = model_group + ([mesh.get_group(a) for a in ctx.data_axes]
                                if tokens_sharded else [])

    def block(xl, rw, wg, wu, wd):
        e_start = (mesh.get_local_rank(ctx.model_axis) * n_local
                   if expert_parallel else 0)
        out, aux = moe_local(xl, rw, wg, wu, wd, cfg=cfg, e_start=e_start,
                             n_local=n_local)
        out = sum_partials(out, model_group)
        aux = sum_partials(aux, aux_groups)
        if tokens_sharded:
            aux = aux / ctx.data_size
        return out, aux

    return local_map(block, out_placements=(tok, rep), in_placements=in_pl,
                     in_grad_placements=in_grad, device_mesh=mesh,
                     redistribute_inputs=True)(
        x2, p.router, p.w_gate, p.w_up, p.w_down)
