"""Plain PyTorch blockwise attention: the streaming-softmax (flash)
algorithm over KV chunks inside a loop over query chunks, O(S·c) memory.

It is the plain version beside the CUDA kernel (``kernel.py``): the
model runs it for CPU tensors, and the kernel is held against it on the
card. Supports GQA grouping, causal, sliding-window, soft-capping, a
custom scale, a value width that differs from the key width, and query
rows that start at position ``q_offset`` (a slice of a longer query, as
the JAX version's ``q_offset``).
"""
from __future__ import annotations

import math

import torch

from .. import remat

NEG_INF = -2.0e38


def blockwise_attention(
    q: torch.Tensor,            # (B, Sq, H, Dk)
    k: torch.Tensor,            # (B, Skv, KV, Dk)
    v: torch.Tensor,            # (B, Skv, KV, Dv)
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    q_offset: int = 0,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    scale: float | None = None,
) -> torch.Tensor:
    B, Sq, H, Dk = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // KV
    if scale is None:
        scale = 1.0 / math.sqrt(Dk)
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    kf, vf = k.float(), v.float()
    out = torch.empty(B, Sq, H, Dv, dtype=q.dtype, device=q.device)

    def kv_step(acc, m, l, qblk, kblk, vblk, qpos, k0):
        kpos = torch.arange(k0, k0 + kblk.shape[1],
                            device=q.device)[None, :]
        s = torch.einsum("bqkgd,bskd->bkgqs", qblk, kblk) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        msk = torch.ones(qblk.shape[1], kblk.shape[1], dtype=torch.bool,
                         device=q.device)
        if causal:
            msk &= kpos <= qpos
        if window is not None:
            msk &= kpos > qpos - window
        s = torch.where(msk, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p, vblk)
        return acc, m_new, l

    # The last chunk of each axis is ragged instead of padded: a padded
    # key is masked to NEG_INF and adds exp(NEG_INF - m) = 0, so both
    # give the same sums. Under autograd each KV step is rematerialised,
    # as in the JAX package.
    for q0 in range(0, Sq, q_chunk):
        qblk = q[:, q0:q0 + q_chunk].float()
        c = qblk.shape[1]
        qblk = qblk.reshape(B, c, KV, G, Dk)
        qpos = torch.arange(q_offset + q0, q_offset + q0 + c,
                            device=q.device)[:, None]
        acc = torch.zeros(B, KV, G, c, Dv, device=q.device)
        m = torch.full((B, KV, G, c), NEG_INF, device=q.device)
        l = torch.zeros(B, KV, G, c, device=q.device)
        for k0 in range(0, Skv, kv_chunk):
            acc, m, l = remat(kv_step, acc, m, l, qblk,
                              kf[:, k0:k0 + kv_chunk],
                              vf[:, k0:k0 + kv_chunk], qpos, k0)
        o = acc / torch.clamp_min(l[..., None], 1e-37)
        # (B, KV, G, c, Dv) -> (B, c, H, Dv)
        out[:, q0:q0 + c] = o.permute(0, 3, 1, 2, 4).reshape(
            B, c, H, Dv).to(q.dtype)
    return out
