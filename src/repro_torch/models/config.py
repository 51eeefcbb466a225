"""Unified model configuration covering all assigned architecture families.

A model is a stack of layers; each layer is (mixer, ffn):
  mixer ∈ {gqa, swa, mla, mamba, rwkv6, none}
  ffn   ∈ {swiglu, gelu, moe}
plus optional encoder (whisper) and stub modality frontends (audio/vlm).

``layer_specs(cfg)`` expands the per-layer pattern; the model groups the
specs into a scannable periodic core + unrolled tail (see model.py) so the
HLO stays small for 80-layer models.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "LayerSpec", "layer_specs", "find_period"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "gqa"       # gqa | swa | mla | mamba | rwkv6
    ffn: str = "swiglu"      # swiglu | gelu | moe
    cross_attn: bool = False  # decoder cross-attention (whisper)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                       # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None       # default d_model // n_heads

    # --- attention ---
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None   # window for 'swa' mixer layers
    local_global_pattern: Optional[Tuple[int, int]] = None  # (n_local, n_global)
    attn_logit_softcap: Optional[float] = None

    # --- MLA (DeepSeek) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    d_ff_expert: int = 0
    moe_period: int = 1                  # every p-th layer is MoE
    moe_offset: int = 0                  # first MoE layer index within period
    dense_prefix: int = 0                # first L layers always dense FFN
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # --- SSM ---
    ssm_kind: Optional[str] = None       # mamba | rwkv6 (for ssm/hybrid archs)
    ssm_period: int = 1                  # attention every p-th layer (hybrid)
    ssm_attn_offset: int = 0             # which index in the period is attn
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2

    # --- encoder/decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0                 # e.g. 1500 audio frames

    # --- modality frontend stubs ---
    frontend: Optional[str] = None       # audio_stub | vision_stub
    frontend_seq: int = 0                # patch/frame tokens prepended
    frontend_dim: int = 0                # raw embedding dim before projector

    # --- numerics / misc ---
    norm_eps: float = 1e-5
    param_dtype: str = "bfloat16"
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    vocab_pad_to: int = 256
    max_seq_len: int = 131_072
    remat: bool = True                   # checkpoint each layer group in bwd
    use_pallas: bool = False             # TPU Pallas kernels for hot spots
    scan_layers: bool = True             # False: unroll (exact dry-run FLOPs;
    #   XLA HLOCostAnalysis counts while-loop bodies once, so the roofline
    #   dry-run unrolls the layer dimension — see launch/dryrun.py)

    # --- §Perf optimization variants (EXPERIMENTS.md; all default OFF so
    #     the baseline dry-runs stay paper-faithful) ---
    mla_absorb: bool = False             # absorbed-MLA decode: attention in
    #   the compressed latent space (no per-step KV decompression)
    grouped_gqa: bool = False            # decode attention grouped by KV
    #   head (no repeat_kv materialization)
    attn_batch_shard_fallback: bool = False  # when q-heads don't divide the
    #   model axis, shard the BATCH over (data x model) for attention
    #   instead of replicating
    seq_shard_decode: bool = False       # decode attention over a sequence-
    #   sharded KV cache via shard_map partial-softmax combine (pmax/psum of
    #   (m, l, out) per layer) instead of letting SPMD all-gather the cache

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError("n_heads must be a multiple of n_kv_heads")

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return (self.vocab_size + p - 1) // p * p

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    def smoke(self) -> "ModelConfig":
        """Reduced variant of the same family for CPU smoke tests:
        <= 2 layers (+2 encoder), d_model <= 512, <= 4 experts."""
        changes = dict(
            n_layers=min(self.n_layers, 2),
            d_model=min(self.d_model, 256),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            head_dim=64,
            max_seq_len=4096,
            param_dtype="float32",
            dtype="float32",
            dense_prefix=min(self.dense_prefix, 1),
            remat=False,
        )
        if self.n_experts:
            changes.update(n_experts=4,
                           experts_per_token=min(self.experts_per_token, 2),
                           n_shared_experts=min(self.n_shared_experts, 1),
                           d_ff_expert=min(self.d_ff_expert, 256) or 256)
        if self.q_lora_rank or self.kv_lora_rank:
            changes.update(q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=32,
                           qk_rope_dim=16, v_head_dim=32, head_dim=48)
        if self.sliding_window:
            changes.update(sliding_window=32)
        if self.encoder_layers:
            changes.update(encoder_layers=2, encoder_seq=64)
        if self.frontend:
            changes.update(frontend_seq=min(self.frontend_seq, 16),
                           frontend_dim=min(self.frontend_dim, 128) or 128)
        if self.ssm_kind:
            changes.update(d_state=8)
        return dataclasses.replace(self, name=self.name + "-smoke", **changes)


def layer_specs(cfg: ModelConfig) -> Tuple[LayerSpec, ...]:
    """Expand the config's layer pattern into one LayerSpec per layer."""
    specs = []
    for l in range(cfg.n_layers):
        # mixer
        if cfg.ssm_kind and cfg.arch_type in ("ssm", "hybrid"):
            if cfg.arch_type == "hybrid" and cfg.ssm_period > 1 \
                    and l % cfg.ssm_period == cfg.ssm_attn_offset:
                mixer = "gqa"
            else:
                mixer = cfg.ssm_kind
        elif cfg.local_global_pattern:
            nl, ng = cfg.local_global_pattern
            mixer = "swa" if (l % (nl + ng)) < nl else "gqa"
        elif cfg.kv_lora_rank:
            mixer = "mla"
        elif cfg.sliding_window and not cfg.local_global_pattern:
            mixer = "swa"
        else:
            mixer = "gqa"
        # ffn
        if cfg.n_experts and l >= cfg.dense_prefix \
                and l % cfg.moe_period == cfg.moe_offset % cfg.moe_period:
            ffn = "moe"
        else:
            ffn = "gelu" if cfg.arch_type == "audio" else "swiglu"
        specs.append(LayerSpec(mixer=mixer, ffn=ffn,
                               cross_attn=cfg.encoder_layers > 0))
    return tuple(specs)


def find_period(specs: Tuple[LayerSpec, ...], max_period: int = 16
                ) -> Tuple[int, int]:
    """Find (period, repeats) maximizing scanned coverage: the smallest p <=
    max_period such that specs is `repeats` copies of specs[:p] plus a tail.
    Returns (p, repeats) with repeats >= 1 (p = len(specs) if aperiodic)."""
    n = len(specs)
    best = (n, 1)
    best_cost = n  # distinct layer bodies in the HLO
    for p in range(1, min(max_period, n) + 1):
        reps = n // p
        if reps < 1:
            continue
        if all(specs[i] == specs[i % p] for i in range(p * reps)):
            cost = p + (n - p * reps)   # scanned bodies + unrolled tail
            if cost < best_cost or (cost == best_cost and p < best[0]):
                best = (p, reps)
                best_cost = cost
    return best
