"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000 — local+global alternating, logit softcap
[arXiv:2408.00118; hf]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b", family="dense",
        n_layers=26, d_model=2304, d_ff=9216, vocab_size=256000,
        n_heads=8, n_kv_heads=4, d_head=256,
        window=4096, local_global_period=2,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        act="gelu", tie_embeddings=True, emb_scale_by_sqrt_dim=True,
        norm_eps=1e-6,
    )


def reduced_config() -> ModelConfig:
    return config().replace(
        name="gemma2-smoke", n_layers=4, d_model=64, d_ff=128,
        vocab_size=256, n_heads=4, n_kv_heads=2, d_head=16, window=32,
        attn_chunk=32, remat=False)
