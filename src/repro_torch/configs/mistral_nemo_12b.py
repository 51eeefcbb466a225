"""mistral-nemo-12b [dense] — 128k context GQA.
[hf:mistralai/Mistral-Nemo-Base-2407]

40L, d_model=5120, 32H (GQA kv=8, head_dim=128), d_ff=14336, vocab=131072.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b",
        arch_type="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131_072,
        rope_theta=1e6,
        max_seq_len=131_072,
    )
