"""Chunked Mamba-2 SSD in plain PyTorch: the CPU path and the on-card
oracle of the CUDA kernel. Mirrors the JAX package's
``ssm_scan_chunked`` and ``ssm_decode_step``.

Within a chunk of length Lc the output is an attention-like masked
product: the decay from step j to step i is exp(cum_i − cum_j) with cum
the running sum of dt·a (≤ 0), and the (P, N) state is carried from
chunk to chunk by a Python loop.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import remat


def ssm_scan_chunked(x, dt, a, Bmat, Cmat, D, h0=None, chunk: int = 256):
    """x (B,S,H,P), dt (B,S,H), a (H,), Bmat/Cmat (B,S,G,N), D (H,), h0
    (B,H,P,N) f32 or None (zeros) → (y (B,S,H,P) in x's dtype, final
    state (B,H,P,N) f32). ``D·x`` is added in f32 before y is rounded."""
    Bsz, S, H, P = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    rep = H // G
    x32, dt32 = x.float(), dt.float()
    B32 = Bmat.float().repeat_interleave(rep, dim=2)         # (B,S,H,N)
    C32 = Cmat.float().repeat_interleave(rep, dim=2)
    a32 = a.float()

    Lc = min(chunk, S)
    pad = (-S) % Lc
    xp = x32
    if pad:   # dt = 0 at the padding: no decay and no input
        xp, B32, C32 = (F.pad(t, (0, 0, 0, 0, 0, pad))
                        for t in (x32, B32, C32))
        dt32 = F.pad(dt32, (0, 0, 0, pad))
    nc = xp.shape[1] // Lc
    xc, Bc, Cc = (t.reshape(Bsz, nc, Lc, H, -1) for t in (xp, B32, C32))
    dtc = dt32.reshape(Bsz, nc, Lc, H)
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    tri = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool,
                                device=x.device))[None, :, :, None]

    def chunk_step(h, xk, dk, Bk, Ck):
        cum = torch.cumsum(dk * a32, dim=1)                  # (B,Lc,H) ≤ 0
        # L[i, j] = exp(cum_i − cum_j) for i ≥ j. For j > i the exponent
        # is positive and may overflow: it is set to −inf before the exp,
        # so neither the value nor the gradient meets an inf (the JAX
        # package's where(tri, exp(diff), 0) gives NaN gradients there).
        diff = cum[:, :, None, :] - cum[:, None, :, :]       # (B,i,j,H)
        Lmat = torch.exp(diff.masked_fill(~tri, float("-inf")))
        CB = torch.einsum("bihn,bjhn->bijh", Ck, Bk)
        W = CB * Lmat * dk[:, None, :, :]                    # weight on x_j
        y_intra = torch.einsum("bijh,bjhp->bihp", W, xk)
        y_inter = torch.einsum("bihn,bhpn->bihp",
                               Ck * torch.exp(cum)[..., None], h)
        decay_to_end = torch.exp(cum[:, -1:, :] - cum)       # (B,Lc,H)
        dB = (dk * decay_to_end)[..., None] * Bk             # (B,Lc,H,N)
        h = (h * torch.exp(cum[:, -1, :])[..., None, None]
             + torch.einsum("bjhn,bjhp->bhpn", dB, xk))
        return h, y_intra + y_inter

    # Under autograd each chunk is rematerialised, as in the JAX package:
    # its backward recomputes the intra-chunk decay and attention tensors.
    ys = []
    for c in range(nc):
        h, y = remat(chunk_step, h, xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c])
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S] + x32 * D.float()[None, None, :, None]
    return y.to(x.dtype), h


def ssm_decode_step(h, x, dt, a, Bmat, Cmat, D):
    """Single-token state update for serving. h (B,H,P,N) f32, x (B,H,P),
    dt (B,H), Bmat/Cmat (B,G,N) → (y (B,H,P) in x's dtype, new state)."""
    rep = x.shape[1] // Bmat.shape[1]
    Bh = Bmat.float().repeat_interleave(rep, dim=1)
    Ch = Cmat.float().repeat_interleave(rep, dim=1)
    dt32 = dt.float()
    decay = torch.exp(dt32 * a.float()[None, :])
    h_new = (h * decay[..., None, None]
             + (dt32[..., None] * x.float())[..., None] * Bh[:, :, None, :])
    y = (torch.einsum("bhpn,bhn->bhp", h_new, Ch)
         + x.float() * D.float()[None, :, None])
    return y.to(x.dtype), h_new
