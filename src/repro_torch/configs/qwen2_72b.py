"""qwen2-72b [dense] — GQA with QKV bias. [arXiv:2407.10671]

80L, d_model=8192, 64H (GQA kv=8), d_ff=29568, vocab=152064.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b",
        arch_type="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152_064,
        qkv_bias=True,
        rope_theta=1e6,
        max_seq_len=131_072,
    )
