"""llama4-maverick-400b-a17b [moe] — 128 routed experts top-1 + shared
expert, interleaved MoE, early-fusion multimodal (vision stub).
[hf:meta-llama/Llama-4-Scout-17B-16E family card, Maverick dims]

48L, d_model=5120, 40H (GQA kv=8), d_ff=8192, vocab=202048; MoE every other
layer (128e top-1 + 1 shared), dense layers use the same 8192 width.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        arch_type="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202_048,
        n_experts=128,
        n_shared_experts=1,
        experts_per_token=1,
        d_ff_expert=8192,
        moe_period=2,
        moe_offset=1,
        frontend="vision_stub",  # early fusion: patch embeds prepended
        frontend_seq=0,          # text-only for the assigned input shapes
        frontend_dim=1408,
        rope_theta=5e5,
        max_seq_len=1_048_576,
    )
