"""hubert-xlarge [audio]: 48L d_model=1280 16H d_ff=5120 vocab=504 —
encoder-only masked-prediction over cluster units; CNN feature extractor
is a STUB (precomputed 512-dim frame embeddings per the assignment)
[arXiv:2106.07447; unverified]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="audio",
        n_layers=48, d_model=1280, d_ff=5120, vocab_size=504,
        n_heads=16, n_kv_heads=16, d_head=80,
        is_encoder=True, causal=False,
        frontend="audio_stub", frontend_dim=512,
        act="gelu",
    )


def reduced_config() -> ModelConfig:
    return config().replace(
        name="hubert-smoke", n_layers=3, d_model=64, d_ff=128,
        vocab_size=64, n_heads=4, n_kv_heads=4, d_head=16,
        frontend_dim=32, attn_chunk=32, remat=False)
