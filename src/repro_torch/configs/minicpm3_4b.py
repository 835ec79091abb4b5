"""minicpm3-4b [dense]: 62L d_model=2560 40H d_ff=6400 vocab=73448 —
MLA (q_lora=768, kv_lora=256, nope/rope 64/32, v=64)
[hf:openbmb/MiniCPM3-4B; hf]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b", family="dense",
        n_layers=62, d_model=2560, d_ff=6400, vocab_size=73448,
        n_heads=40, attn_type="mla",
        q_lora_rank=768, kv_lora_rank=256,
        qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
        act="silu", tie_embeddings=True,
    )


def reduced_config() -> ModelConfig:
    return config().replace(
        name="minicpm3-smoke", n_layers=3, d_model=64, d_ff=128,
        vocab_size=250, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
        qk_nope_dim=8, qk_rope_dim=4, v_head_dim=8,
        attn_chunk=32, remat=False)
