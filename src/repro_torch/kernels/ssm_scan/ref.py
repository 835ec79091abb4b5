"""Sequential oracle for the Mamba-2 selective state-space scan (SSD).

    h_t = exp(dt_t · a_h) · h_{t-1} + dt_t · x_t ⊗ B_t
    y_t = C_t · h_t + D_h · x_t

Shapes follow Mamba-2: x (B,S,H,P), dt (B,S,H) [post-softplus], a (H,)
[negative], Bmat/Cmat (B,S,G,N) with G state groups shared by H/G heads
each, D (H,). The state h is (B,H,P,N).
"""
from __future__ import annotations

import torch


def ssm_scan_ref(x, dt, a, Bmat, Cmat, D, h0=None):
    """A Python loop over time in f32 → (y like x, final state f32)."""
    Bsz, S, H, P = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    rep = H // G
    x32, dt32 = x.float(), dt.float()
    B32 = Bmat.float().repeat_interleave(rep, dim=2)         # (B,S,H,N)
    C32 = Cmat.float().repeat_interleave(rep, dim=2)
    a32 = a.float()
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        decay = torch.exp(dt32[:, t] * a32[None, :])          # (B,H)
        h = (h * decay[..., None, None]
             + (dt32[:, t, :, None] * x32[:, t])[..., None]
             * B32[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, C32[:, t]))
    y = torch.stack(ys, dim=1) + x32 * D.float()[None, None, :, None]
    return y.to(x.dtype), h
