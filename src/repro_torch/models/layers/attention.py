"""GQA attention layer with train / prefill / decode paths.

The KV cache is a ring buffer of capacity ``C`` (= window size for
sliding-window archs, = max context otherwise). RoPE is applied to keys
before caching, so ring rotation only affects masking, which is computed
from reconstructed absolute slot positions.

Prefill and train attention go through ``ops.attention``: the CUDA
flash kernel on the card, the plain blockwise version on the CPU.
Decode attends one token over the whole cache in plain PyTorch.

Unlike the JAX layer, which returns new cache arrays, this one writes
the cache tensors in place (one slot per decode step instead of a copy
of the cache) and returns the same dict.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...kernels.flash_attention import ops
from .common import rope, softcap, weight

NEG_INF = -2.0e38


def _prefill_cache(buf, kv):
    """Write S freshly computed entries into a ring buffer of capacity C,
    in place. S ≤ C: plain placement at slots 0..S−1 (absolute = slot).
    S > C: keep the last C entries, rotated so the entry at absolute
    position p sits in slot p % C."""
    S, C = kv.shape[1], buf.shape[1]
    if S <= C:
        buf[:, :S].copy_(kv)
    else:
        buf.copy_(torch.roll(kv[:, S - C:], shifts=(S - C) % C, dims=1))


def _ring_positions(capacity: int, pos: int, device):
    """Absolute position held by each cache slot after writing ``pos``."""
    s = torch.arange(capacity, device=device)
    return pos - torch.remainder(pos - s, capacity)


def _decode_attend(q, ck, cv, pos, capacity, window, cap):
    """Single-token attention over a ring-buffer cache."""
    B, S, H, Dh = q.shape               # S == 1
    KV = ck.shape[2]
    G = H // KV
    abs_pos = _ring_positions(capacity, pos, q.device)
    valid = (abs_pos >= 0) & (abs_pos <= pos)
    if window is not None:
        valid &= abs_pos > pos - window
    qg = q.reshape(B, S, KV, G, Dh).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, ck.float()) / math.sqrt(Dh)
    s = softcap(s, cap)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, cv.float())
    return out.reshape(B, S, H, cv.shape[-1]).to(q.dtype)


class Attention(nn.Module):
    """wq (D_in, H, Dh), wk/wv (D_in, KV, Dh), wo (H, Dh, D_out);
    ``d_in`` and ``d_out`` default to ``cfg.d_model``, as in the JAX
    package's ``init_attn``."""

    def __init__(self, cfg, dtype, device, d_in: int | None = None,
                 d_out: int | None = None):
        super().__init__()
        D, H, KV, Dh = (d_in or cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.d_head)

        def w(*shape):
            return weight(*shape, dtype=dtype, device=device)
        self.wq, self.wk, self.wv = w(D, H, Dh), w(D, KV, Dh), w(D, KV, Dh)
        self.wo = w(H, Dh, d_out or cfg.d_model)
        self.cfg = cfg

    def forward(self, x, *, positions, window=None, cache=None, pos=None,
                mode="train", causal=True, dtype=torch.bfloat16):
        """x (B, S, D) → (out (B, S, D), cache); ``causal=False`` for an
        encoder (hubert-xlarge)."""
        cfg = self.cfg
        B, S, D = x.shape
        H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        xq = x.to(dtype)
        q = (xq @ self.wq.to(dtype).reshape(D, H * Dh)).view(B, S, H, Dh)
        k = (xq @ self.wk.to(dtype).reshape(D, KV * Dh)).view(B, S, KV, Dh)
        v = (xq @ self.wv.to(dtype).reshape(D, KV * Dh)).view(B, S, KV, Dh)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

        cap = cfg.attn_logit_softcap
        if mode in ("train", "prefill"):
            if mode == "prefill":
                _prefill_cache(cache["k"], k)
                _prefill_cache(cache["v"], v)
            out = ops.attention(q, k, v, causal=causal, window=window,
                                softcap=cap, q_chunk=cfg.attn_chunk,
                                kv_chunk=2 * cfg.attn_chunk)
        elif mode == "decode":
            capacity = cache["k"].shape[1]
            slot = pos % capacity
            # In-place write of this step's entry into its ring slot.
            cache["k"][:, slot:slot + 1].copy_(k)
            cache["v"][:, slot:slot + 1].copy_(v)
            out = _decode_attend(q, cache["k"], cache["v"], pos, capacity,
                                 window, cap)
        else:
            raise ValueError(mode)
        out = out.to(dtype).reshape(B, S, H * Dh) @ self.wo.to(
            dtype).reshape(H * Dh, -1)
        return out, cache
