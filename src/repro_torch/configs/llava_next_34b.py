"""llava-next-34b [vlm] — anyres tiling; ViT tower + projector STUBBED
(input_specs provides patch embeddings). [hf:llava-hf/llava-v1.6-*, 34B
backbone = Yi-34B dims]

60L, d_model=7168, 56H (GQA kv=8), d_ff=20480, vocab=64000. The assigned
input shapes allocate 1024 positions of each sequence to anyres patch
embeddings (CLIP-ViT-L/336 hidden = 1024).
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b",
        arch_type="vlm",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab_size=64_000,
        frontend="vision_stub",
        frontend_seq=1024,       # anyres patch tokens per sequence
        frontend_dim=1024,       # CLIP-ViT-L hidden
        rope_theta=5e6,
        max_seq_len=131_072,
    )
