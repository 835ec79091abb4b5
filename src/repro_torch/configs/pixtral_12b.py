"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 — pixtral-ViT frontend (STUB: precomputed 1024-dim patch
embeddings per the assignment) + mistral-nemo-style decoder
[hf:mistralai/Pixtral-12B-2409; unverified]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", family="vlm",
        n_layers=40, d_model=5120, d_ff=14336, vocab_size=131072,
        n_heads=32, n_kv_heads=8, d_head=128,
        frontend="vision_stub", frontend_dim=1024, frontend_tokens=1024,
        act="silu", rope_theta=1e9,
    )


def reduced_config() -> ModelConfig:
    return config().replace(
        name="pixtral-smoke", n_layers=3, d_model=64, d_ff=128,
        vocab_size=256, n_heads=4, n_kv_heads=2, d_head=16,
        frontend_dim=32, frontend_tokens=8, attn_chunk=32, remat=False)
