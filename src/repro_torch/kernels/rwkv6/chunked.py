"""Chunked RWKV-6 WKV in plain PyTorch: the CPU path and the on-card
oracle of the CUDA kernel. Mirrors the JAX package's ``wkv6_chunked``.

Within a chunk of length Lc, decay products are exp of cumulative
log-decay differences; the intra-chunk term is an explicit (i, j,
channel) tensor over the chunk, and the (K, K) state is carried from
chunk to chunk by a Python loop.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import remat


def wkv6_chunked(r, k, v, w, u, s0=None, chunk: int = 32):
    """r/k/v/w (B,S,H,K), u (H,K), s0 (B,H,K,K) f32 or None (zeros) →
    (y (B,S,H,K) in r's dtype, final state (B,H,K,K) f32)."""
    B, S, H, K = r.shape
    r32, k32, v32 = (t.float() for t in (r, k, v))
    lw = torch.log(torch.clamp(w.float(), 1e-38, 1.0))       # ≤ 0
    u32 = u.float()

    Lc = min(chunk, S)
    pad = (-S) % Lc
    if pad:   # lw = 0 (w = 1) and k = 0: padding neither decays nor feeds
        r32, k32, v32, lw = (F.pad(t, (0, 0, 0, 0, 0, pad))
                             for t in (r32, k32, v32, lw))
    nc = r32.shape[1] // Lc
    rc, kc, vc, lwc = (t.reshape(B, nc, Lc, H, K)
                       for t in (r32, k32, v32, lw))
    s = (torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    strict = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool,
                                   device=r.device), -1)[None, :, :, None,
                                                         None]

    def chunk_step(s, rk, kk, vk, lwk):
        cum = torch.cumsum(lwk, dim=1)                       # (B,Lc,H,K)
        # S_{i-1} sees decay Π_{p=j+1..i-1} w_p = exp(cum_{i-1} − cum_j)
        cum_im1 = F.pad(cum, (0, 0, 0, 0, 1, 0))[:, :-1]
        diff = cum_im1[:, :, None] - cum[:, None]            # (B,i,j,H,K)
        # For j ≥ i the exponent is positive and may overflow: it is set
        # to −inf before the exp, so neither the value nor the gradient
        # meets an inf (where(mask, exp(diff), 0) is right forward, but
        # its backward multiplies the masked zeros by exp(diff) = inf:
        # NaN, as the JAX package's does).
        decay = torch.exp(diff.masked_fill(~strict, float("-inf")))
        A = torch.einsum("bihk,bijhk,bjhk->bijh", rk, decay, kk)
        diag = torch.einsum("bihk,hk,bihk->bih", rk, u32, kk)
        y_intra = (torch.einsum("bijh,bjhv->bihv", A, vk)
                   + diag[..., None] * vk)
        y_inter = torch.einsum("bihk,bhkv->bihv", rk * torch.exp(cum_im1),
                               s)
        decay_end = torch.exp(cum[:, -1:] - cum)             # (B,Lc,H,K)
        kv = torch.einsum("bjhk,bjhv->bhkv", kk * decay_end, vk)
        return torch.exp(cum[:, -1])[..., None] * s + kv, y_intra + y_inter

    # Under autograd each chunk is rematerialised, as in the JAX package:
    # its backward recomputes the (i, j, channel) decay tensor.
    ys = []
    for c in range(nc):
        s, y = remat(chunk_step, s, rc[:, c], kc[:, c], vc[:, c], lwc[:, c])
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S]
    return y.to(r.dtype), s


def wkv6_decode_step(s, r, k, v, w, u):
    """Single-token WKV step. r/k/v/w (B,H,K), u (H,K); s (B,H,K,K) f32
    → (y (B,H,K) in r's dtype, new state)."""
    r32, k32, v32 = (t.float() for t in (r, k, v))
    w32 = w.float()
    kv = k32[..., :, None] * v32[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", r32,
                     s + u.float()[None, :, :, None] * kv)
    s_new = w32[..., :, None] * s + kv
    return y.to(r.dtype), s_new
