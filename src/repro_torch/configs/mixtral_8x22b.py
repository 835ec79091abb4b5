"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, 8 experts top-2, SWA window 4096 [arXiv:2401.04088; hf]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        n_layers=56, d_model=6144, d_ff=16384, vocab_size=32768,
        n_heads=48, n_kv_heads=8, d_head=128,
        n_experts=8, moe_top_k=2, moe_d_ff=16384,
        window=4096, act="silu", rope_theta=1e6,
        param_dtype="bfloat16",  # 141B parameters, kept in bf16
    )


def reduced_config() -> ModelConfig:
    return config().replace(
        name="mixtral-smoke", n_layers=3, d_model=64, d_ff=128,
        vocab_size=256, n_heads=4, n_kv_heads=2, d_head=16,
        n_experts=4, moe_top_k=2, moe_d_ff=128, window=32,
        attn_chunk=32, remat=False)
