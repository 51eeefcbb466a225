"""gemma3-4b [dense] — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt family card, 4b dims]

34L, d_model=2560, 8H (GQA kv=4), d_ff=10240, vocab=262144.
Local layers use a 1024-token sliding window; every 6th layer is global.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b",
        arch_type="dense",
        n_layers=34,
        d_model=2560,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=10240,
        vocab_size=262_144,
        sliding_window=1024,
        local_global_pattern=(5, 1),
        attn_logit_softcap=None,
        rope_theta=1e6,
        max_seq_len=131_072,
    )
