"""rwkv6-1.6b [ssm] — Finch: attention-free, data-dependent decay.
[arXiv:2404.05892]

24L, d_model=2048 (32 heads of 64 for the WKV state), d_ff=7168,
vocab=65536.  Each layer is the RWKV-6 time-mix with a SwiGLU
feed-forward (``layer_specs``); the decode state is O(1) per layer.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        arch_type="ssm",
        n_layers=24,
        d_model=2048,
        n_heads=32,              # wkv head dim 64
        n_kv_heads=32,
        head_dim=64,
        d_ff=7168,
        vocab_size=65536,
        ssm_kind="rwkv6",
        max_seq_len=1_048_576,   # state is O(1); no positional limit
    )
