"""jamba-v0.1-52b [hybrid] — Mamba + attention 1:7 interleave, MoE 16e top-2
every other layer. [arXiv:2403.19887]

32L, d_model=4096, 32H (GQA kv=8), d_ff=14336, vocab=65536.
A Jamba block is 8 layers with one attention layer (offset 4): the other
seven are Mamba mixers (d_inner 8192, d_state 16, d_conv 4).  MoE replaces
the MLP on every other layer (16 experts, top-2, no shared expert).
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        arch_type="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        ssm_kind="mamba",
        ssm_period=8,
        ssm_attn_offset=4,
        d_state=16,
        d_conv=4,
        expand=2,
        n_experts=16,
        experts_per_token=2,
        d_ff_expert=14336,
        moe_period=2,
        moe_offset=1,
        rope_theta=1e6,
        max_seq_len=262_144,
    )
