"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H d_ff=10240 vocab=32000,
ssm_state=64 — Mamba2 backbone + shared attention block every 6 blocks
(concat(hidden, embed0), 2*d wide) [arXiv:2411.15242; hf].
Shared attention uses a 4096 sliding window so the 500k-context decode
state stays bounded (per-invocation LoRAs omitted)."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        n_layers=54, d_model=2560, d_ff=10240, vocab_size=32000,
        n_heads=32, n_kv_heads=32, d_head=160,
        ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
        hybrid_attn_period=6, window=4096,
        act="gelu", tie_embeddings=True,
    )


def reduced_config() -> ModelConfig:
    return config().replace(
        name="zamba2-smoke", n_layers=4, d_model=48, d_ff=96,
        vocab_size=256, n_heads=4, n_kv_heads=4, d_head=24,
        ssm_state=8, ssm_head_dim=16, hybrid_attn_period=2, window=32,
        attn_chunk=32, ssm_chunk=16, remat=False)
