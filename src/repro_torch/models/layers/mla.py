"""Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3), absorbed form:
the JAX package's ``mla_apply``.

The cache keeps only the compressed latent ``c_kv`` (kv_lora_rank) and
the decoupled RoPE key (qk_rope_dim). W^UK is absorbed into the query,
so attention is MQA in the latent space with key width kv_lora + rope
and value width kv_lora:

    q_abs = q_nope · W^UK          (B, S, H, kv_lora)
    score = (q_abs·c_kv + q_rope·k_rope) / sqrt(qk_nope + qk_rope)
    ctx   = softmax(score) · c_kv  (B, S, H, kv_lora)
    out   = (ctx · W^UV) · W^O

Train and prefill attend through ``ops.attention`` (the CUDA flash
kernel on the card, at minicpm3-4b's Dk 288 / Dv 256 and deepseek-v2's
Dk 576 / Dv 512, whose value columns the kernel splits into two slices
of 256); the value is a view of the key's first kv_lora columns. Decode
attends one token over the ring-buffer latent cache in plain PyTorch, as
the JAX layer's einsums do. The cache tensors are written in place.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...kernels.flash_attention import ops
from .attention import NEG_INF, _ring_positions
from .common import rms_norm, rope, weight


class MLA(nn.Module):
    """wq_a (D, q_lora), q_a_norm (q_lora,), wq_b (q_lora, H, nope + rope)
    (or wq (D, H, nope + rope) when q_lora_rank is 0); wkv_a (D, kv_lora +
    rope), kv_a_norm (kv_lora,); wk_b (kv_lora, H, nope), wv_b (kv_lora,
    H, v_head); wo (H, v_head, D). The norm scales stay f32."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        D, H = cfg.d_model, cfg.n_heads
        r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim

        def w(*shape):
            return weight(*shape, dtype=dtype, device=device)
        if r_q:
            self.wq_a = w(D, r_q)
            self.q_a_norm = weight(r_q, dtype=torch.float32, device=device)
            self.wq_b = w(r_q, H, dn + dr)
        else:
            self.wq = w(D, H, dn + dr)
        self.wkv_a = w(D, r_kv + dr)
        self.kv_a_norm = weight(r_kv, dtype=torch.float32, device=device)
        self.wk_b, self.wv_b = w(r_kv, H, dn), w(r_kv, H, dv)
        self.wo = w(H, dv, D)
        self.cfg = cfg

    def _latents(self, x, positions, dtype):
        """q_abs (B, S, H, kv_lora), q_rope (B, S, H, rope), c_kv (B, S,
        kv_lora), k_rope (B, S, rope)."""
        cfg = self.cfg
        dn, r_kv = cfg.qk_nope_dim, cfg.kv_lora_rank
        if cfg.q_lora_rank:
            qa = rms_norm(x @ self.wq_a.to(dtype), self.q_a_norm,
                          cfg.norm_eps, plus_one=True)
            q = torch.einsum("bsr,rhk->bshk", qa, self.wq_b.to(dtype))
        else:
            q = torch.einsum("bsd,dhk->bshk", x, self.wq.to(dtype))
        q_nope, q_rope = q[..., :dn], q[..., dn:]
        q_rope = rope(q_rope, positions, cfg.rope_theta)
        q_abs = torch.einsum("bshn,rhn->bshr", q_nope, self.wk_b.to(dtype))
        kv = x @ self.wkv_a.to(dtype)
        c_kv = rms_norm(kv[..., :r_kv], self.kv_a_norm, cfg.norm_eps,
                        plus_one=True)
        k_rope = rope(kv[..., r_kv:][:, :, None, :], positions,
                      cfg.rope_theta)[:, :, 0, :]
        return q_abs, q_rope, c_kv, k_rope

    def forward(self, x, *, positions, cache=None, pos=None, mode="train",
                dtype=torch.bfloat16):
        """x (B, S, D) → (out (B, S, D), cache {"ckv", "krope"})."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, r_kv = cfg.n_heads, cfg.kv_lora_rank
        scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
        x = x.to(dtype)
        q_abs, q_rope, c_kv, k_rope = self._latents(x, positions, dtype)

        if mode in ("train", "prefill"):
            if mode == "prefill":
                if S > cache["ckv"].shape[1]:
                    raise ValueError(f"MLA prefill of {S} tokens into a "
                                     f"cache of {cache['ckv'].shape[1]}")
                cache["ckv"][:, :S].copy_(c_kv)
                cache["krope"][:, :S].copy_(k_rope)
            q_cat = torch.cat([q_abs, q_rope], dim=-1)
            k_cat = torch.cat([c_kv, k_rope], dim=-1)[:, :, None, :]
            ctx = ops.attention(q_cat, k_cat, k_cat[..., :r_kv], causal=True,
                                scale=scale, q_chunk=cfg.attn_chunk,
                                kv_chunk=2 * cfg.attn_chunk)
        elif mode == "decode":
            ckv, krp = cache["ckv"], cache["krope"]
            capacity = ckv.shape[1]
            slot = pos % capacity
            ckv[:, slot:slot + 1].copy_(c_kv)
            krp[:, slot:slot + 1].copy_(k_rope)
            abs_pos = _ring_positions(capacity, pos, x.device)
            valid = (abs_pos >= 0) & (abs_pos <= pos)
            ckv32 = ckv.float()
            s = (torch.einsum("bqhr,bsr->bhqs", q_abs.float(), ckv32)
                 + torch.einsum("bqhr,bsr->bhqs", q_rope.float(),
                                krp.float())) * scale
            s = torch.where(valid, s, NEG_INF)
            p = torch.softmax(s, dim=-1)
            ctx = torch.einsum("bhqs,bsr->bqhr", p, ckv32).to(dtype)
        else:
            raise ValueError(mode)

        v = torch.einsum("bshr,rhv->bshv", ctx.to(dtype), self.wv_b.to(dtype))
        out = v.reshape(B, S, -1) @ self.wo.to(dtype).reshape(
            -1, cfg.d_model)
        return out, cache
