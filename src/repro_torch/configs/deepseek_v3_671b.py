"""deepseek-v3-671b [moe] — MLA + 1 shared + 256 routed experts (top-8).
[arXiv:2412.19437]

61L, d_model=7168, 128 heads (MLA; assigned GQA kv=128 ≙ full heads through
the latent), d_ff_expert=2048 (assigned d_ff), vocab=129280. First 3 layers
dense (d_ff=18432 per the paper). MLA dims: q_lora=1536, kv_lora=512,
qk_nope=128, qk_rope=64, v_head=128. The multi-token-prediction head is
out of scope, as in the reference.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        arch_type="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        head_dim=192,            # qk_nope + qk_rope
        d_ff=18432,              # dense-prefix MLP width (paper)
        vocab_size=129_280,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        n_experts=256,
        n_shared_experts=1,
        experts_per_token=8,
        d_ff_expert=2048,        # assigned d_ff (routed expert width)
        dense_prefix=3,
        moe_period=1,
        rope_theta=1e4,
        max_seq_len=131_072,
    )
