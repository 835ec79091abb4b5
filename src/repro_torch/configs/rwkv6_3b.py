"""rwkv6-3b (Finch) [ssm]: 32L d_model=2560 (attn-free) d_ff=8960
vocab=65536 — data-dependent decay WKV [arXiv:2404.05892; hf]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", family="ssm",
        n_layers=32, d_model=2560, d_ff=8960, vocab_size=65536,
        attn_type="none", rwkv_head_dim=64,
        rwkv_decay_lora=64, rwkv_mix_lora=32,
        ssm_chunk=32,   # WKV chunk: the (i,j,channel) intra tensor is O(Lc^2 K)
        act="relu",
    )


def reduced_config() -> ModelConfig:
    return config().replace(
        name="rwkv6-smoke", n_layers=3, d_model=64, d_ff=128,
        vocab_size=256, rwkv_head_dim=16, rwkv_decay_lora=16,
        rwkv_mix_lora=8, ssm_chunk=16, remat=False)
