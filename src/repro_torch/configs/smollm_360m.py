"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560
vocab=49152 — llama-arch small [hf:HuggingFaceTB/SmolLM-360M; hf]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m", family="dense",
        n_layers=32, d_model=960, d_ff=2560, vocab_size=49152,
        n_heads=15, n_kv_heads=5, d_head=64,
        act="silu", tie_embeddings=True,
    )


def reduced_config() -> ModelConfig:
    return config().replace(
        name="smollm-smoke", n_layers=3, d_model=60, d_ff=96,
        vocab_size=256, n_heads=3, n_kv_heads=1, d_head=20,
        attn_chunk=32, remat=False)
