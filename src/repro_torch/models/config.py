"""Unified architecture config (the port's own copy of the JAX package's
``ModelConfig``; same fields and defaults, so configs compare like for
like). Family-specific fields are inert elsewhere. Exact values for each
ported architecture live in ``repro_torch/configs/<id>.py``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0

    # ---- attention variants
    attn_type: str = "gqa"        # gqa | mla | none
    causal: bool = True
    window: int | None = None     # sliding-window size (SWA / local layers)
    local_global_period: int = 0  # gemma2: alternate local/global every k
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    rope_theta: float = 10000.0
    qk_norm: bool = False

    # ---- MLA (DeepSeek-V2 / MiniCPM3)
    q_lora_rank: int = 0          # 0 = full-rank q projection
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # ---- MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0             # per-expert hidden
    first_dense_layers: int = 0   # leading dense layers before MoE stack
    moe_capacity_factor: float = 1.25

    # ---- SSM (Mamba2) / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    hybrid_attn_period: int = 0   # zamba2: shared attn block every k blocks

    # ---- RWKV6
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64
    rwkv_mix_lora: int = 32

    # ---- encoder / modality frontends
    is_encoder: bool = False
    frontend: str | None = None   # "vision_stub" | "audio_stub"
    frontend_dim: int = 0
    frontend_tokens: int = 0

    # ---- numerics / runtime
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"             # silu | gelu | relu
    emb_scale_by_sqrt_dim: bool = False
    dtype: str = "bfloat16"       # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True
    attn_chunk: int = 512         # q-chunk for the plain blockwise attention
    ssm_chunk: int = 256
    loss_chunk: int = 512
    use_kernels: bool = False

    def __post_init__(self):
        if self.attn_type == "gqa" and self.n_heads and not self.d_head:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.family == "moe" and not self.moe_d_ff:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    @property
    def q_per_kv(self) -> int:
        return max(1, self.n_heads // max(self.n_kv_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a shardable multiple (Megatron-style)."""
        m = 256
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve a 500k context (bounded per-token state)?"""
        if self.family in ("ssm",):
            return True
        if self.family == "hybrid":
            return True             # SSM backbone + windowed shared attn
        if self.window is not None and self.local_global_period == 0:
            return True             # pure SWA (mixtral)
        return False

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (total, incl. embeddings), JAX's
        formula (the roofline's; not the exact tree size)."""
        D, F, L, V = self.d_model, self.d_ff, self.n_layers, self.padded_vocab
        n = V * D  # embed
        if not self.tie_embeddings:
            n += D * V
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "audio"):
            per_layer += self._attn_params()
            if self.family == "moe":
                e = self.n_experts + self.n_shared_experts
                per_layer += 3 * D * self.moe_d_ff * e + D * self.n_experts
            else:
                per_layer += 3 * D * F
            per_layer += 2 * D  # norms
            n += per_layer * L
            if self.family == "moe" and self.first_dense_layers:
                n += (3 * D * F - 3 * D * self.moe_d_ff
                      * (self.n_experts + self.n_shared_experts)
                      - D * self.n_experts) * self.first_dense_layers
        elif self.family in ("ssm", "hybrid"):
            di = self.d_inner
            mamba = (D * (2 * di + 2 * self.ssm_heads *
                          self.ssm_state)  # in/x proj approx
                     + di * D + di * self.ssm_conv + 2 * D)
            if self.family == "ssm" and self.name.startswith("rwkv"):
                mamba = 0
            n += mamba * L
            if self.hybrid_attn_period:
                n += self._attn_params(2 * D) + 3 * (2 * D) * self.d_ff
        if self.name.startswith("rwkv"):
            n += L * (4 * D * D + D * F + F * D + 6 * D)
        return n

    def _attn_params(self, d_in: int | None = None) -> int:
        D = d_in or self.d_model
        if self.attn_type == "mla":
            q = (D * self.q_lora_rank
                 + self.q_lora_rank * self.n_heads
                 * (self.qk_nope_dim + self.qk_rope_dim)
                 if self.q_lora_rank else
                 D * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim))
            kv = (D * (self.kv_lora_rank + self.qk_rope_dim)
                  + self.kv_lora_rank * self.n_heads
                  * (self.qk_nope_dim + self.v_head_dim))
            o = self.n_heads * self.v_head_dim * self.d_model
            return q + kv + o
        H, KV, Dh = self.n_heads, self.n_kv_heads, self.d_head
        return D * H * Dh + 2 * D * KV * Dh + H * Dh * self.d_model
