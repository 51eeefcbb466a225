"""phi4-mini-3.8b [dense] — RoPE + SwiGLU + GQA. [arXiv:2412.08905]

32L, d_model=3072, 24H (GQA kv=8), d_ff=8192, vocab=200064.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b",
        arch_type="dense",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=200_064,
        rope_theta=1e4,
        max_seq_len=131_072,
    )
