"""O(S²) oracle for attention: direct softmax(Q·Kᵀ)·V with GQA head
grouping, causal / sliding-window masking and tanh logit soft-capping.
For oracle comparisons at small shapes only."""
from __future__ import annotations

import math

import torch

NEG_INF = -2.0e38


def attention_ref(
    q: torch.Tensor,            # (B, Sq, H, Dk)
    k: torch.Tensor,            # (B, Skv, KV, Dk)
    v: torch.Tensor,            # (B, Skv, KV, Dv)
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    B, Sq, H, Dk = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    if scale is None:
        scale = 1.0 / math.sqrt(Dk)
    qg = q.reshape(B, Sq, KV, G, Dk).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)
