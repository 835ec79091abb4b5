"""deepseek-v2-236b [moe]: 60L d_model=5120 128H vocab=102400 — MLA
(q_lora=1536, kv_lora=512, nope/rope 128/64, v=128), 2 shared + 160
routed experts top-6 (expert d_ff=1536), first layer dense (d_ff=12288)
[arXiv:2405.04434; hf]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="moe",
        n_layers=60, d_model=5120, d_ff=12288, vocab_size=102400,
        n_heads=128, attn_type="mla",
        q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        n_experts=160, n_shared_experts=2, moe_top_k=6, moe_d_ff=1536,
        first_dense_layers=1,
        act="silu",
        param_dtype="bfloat16",  # 236B parameters, kept in bf16
    )


def reduced_config() -> ModelConfig:
    return config().replace(
        name="deepseek-v2-smoke", n_layers=3, d_model=64, d_ff=160,
        vocab_size=256, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
        qk_nope_dim=8, qk_rope_dim=4, v_head_dim=8,
        n_experts=8, n_shared_experts=1, moe_top_k=2, moe_d_ff=32,
        first_dense_layers=1, attn_chunk=32, remat=False)
