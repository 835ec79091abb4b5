"""internlm2-20b [dense]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544 [arXiv:2403.17297; hf]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b", family="dense",
        n_layers=48, d_model=6144, d_ff=16384, vocab_size=92544,
        n_heads=48, n_kv_heads=8, d_head=128,
        act="silu", rope_theta=1e6,
    )


def reduced_config() -> ModelConfig:
    return config().replace(
        name="internlm2-smoke", n_layers=3, d_model=64, d_ff=160,
        vocab_size=256, n_heads=4, n_kv_heads=2, d_head=16,
        attn_chunk=32, remat=False)
