"""whisper-base [audio] — encoder-decoder; the conv/mel frontend is a stub
(the encoder takes precomputed 1500-frame embeddings). [arXiv:2212.04356]

6L decoder + 6L encoder, d_model=512, 8H (kv=8), d_ff=2048, vocab=51865
(padded to 51968).  Layer norms, GELU feed-forwards, a learned decoder
position table of max_seq_len rows and no RoPE.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        arch_type="audio",
        n_layers=6,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        head_dim=64,
        d_ff=2048,
        vocab_size=51_865,
        encoder_layers=6,
        encoder_seq=1500,
        frontend="audio_stub",
        frontend_dim=512,        # post-conv frame embedding width
        max_seq_len=32_768,      # past the model card's 448 positions
    )
