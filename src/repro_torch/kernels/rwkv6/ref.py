"""Sequential oracle for the RWKV-6 (Finch) WKV recurrence.

Per head (K = V = head dim), with data-dependent per-channel decay
w_t ∈ (0,1) and bonus u:

    y_t = r_t · (S_{t-1} + diag(u) · (k_t ⊗ v_t))
    S_t = diag(w_t) · S_{t-1} + k_t ⊗ v_t

Shapes: r/k/v/w (B,S,H,K), u (H,K); state S (B,H,K,K) [key-major].
"""
from __future__ import annotations

import torch


def wkv6_ref(r, k, v, w, u, s0=None):
    """A Python loop over time in f32 → (y like r, final state f32)."""
    B, S, H, K = r.shape
    r32, k32, v32, w32 = (t.float() for t in (r, k, v, w))
    u32 = u.float()
    s = (torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    ys = []
    for t in range(S):
        kv = k32[:, t, :, :, None] * v32[:, t, :, None, :]   # (B,H,K,K)
        ys.append(torch.einsum("bhk,bhkv->bhv", r32[:, t],
                               s + u32[None, :, :, None] * kv))
        s = w32[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1).to(r.dtype), s
