"""Mamba-2 block: fused in_proj, causal depthwise conv, SSD scan, gated
RMSNorm and out_proj (the JAX package's ``models/layers/mamba2.py``).

Decode state per block: the conv's last K−1 input rows (B, K−1, conv
channels) in the cache dtype and the SSM state (B, H, P, N) in f32 — a
constant size whatever the context. Prefill runs the scan through
``ops.ssm_scan`` (the CUDA kernel on the card, the plain chunked version
on the CPU); decode runs the plain single-step update, as in JAX.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...kernels.ssm_scan import ops
from ...kernels.ssm_scan.chunked import ssm_decode_step
from .common import rms_norm, weight

G = 1  # state groups


def conv_dim(cfg) -> int:
    return cfg.d_inner + 2 * G * cfg.ssm_state


def init_mamba_state(cfg, batch: int, dtype, device):
    """One block's serving state: {"conv": (B, K−1, conv channels) in
    ``dtype``, "ssm": (B, H, P, N) f32}, all zero."""
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim(cfg)),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                                cfg.ssm_state), dtype=torch.float32,
                               device=device)}


def causal_conv(xBC, w, b, state=None):
    """Depthwise causal conv along time in ``xBC``'s dtype, then SiLU.
    xBC (B,S,C), w (K,C), b (C,), state (B,K−1,C) or None (zeros) →
    (out (B,S,C), the last K−1 input rows (B,K−1,C))."""
    K, S = w.shape[0], xBC.shape[1]
    pad = (xBC.new_zeros((xBC.shape[0], K - 1, xBC.shape[2]))
           if state is None else state.to(xBC.dtype))
    xp = torch.cat([pad, xBC], dim=1)
    out = xp[:, :S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    return F.silu(out + b), xp[:, xp.shape[1] - (K - 1):]


class Mamba2(nn.Module):
    """in_proj (D, 2·d_inner + 2·G·N + H), conv_w (K, conv channels),
    conv_b, out_proj (d_inner, D) in the compute dtype; dt_bias, A_log,
    D (H,) and the gated norm's scale (d_inner,) in f32, as the JAX layer
    computes with them."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        D, di, H = cfg.d_model, cfg.d_inner, cfg.ssm_heads
        f32 = torch.float32
        self.in_proj = weight(D, 2 * di + 2 * G * cfg.ssm_state + H,
                              dtype=dtype, device=device)
        self.conv_w = weight(cfg.ssm_conv, conv_dim(cfg), dtype=dtype,
                             device=device)
        self.conv_b = weight(conv_dim(cfg), dtype=dtype, device=device)
        self.dt_bias = weight(H, dtype=f32, device=device)
        self.A_log = weight(H, dtype=f32, device=device)
        self.D = weight(H, dtype=f32, device=device)
        self.norm = weight(di, dtype=f32, device=device)
        self.out_proj = weight(di, D, dtype=dtype, device=device)
        self.cfg = cfg

    def forward(self, x, *, state=None, mode="train", dtype=torch.bfloat16):
        """x (B,S,D) → (out (B,S,D), new state {"conv", "ssm"} in
        prefill/decode, else None)."""
        cfg = self.cfg
        B, S, _ = x.shape
        di, N = cfg.d_inner, cfg.ssm_state
        H, P = cfg.ssm_heads, cfg.ssm_head_dim
        zxbcdt = x.to(dtype) @ self.in_proj.to(dtype)
        z, xBC, dt = torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)
        xBC, new_conv = causal_conv(xBC, self.conv_w.to(dtype),
                                    self.conv_b.to(dtype),
                                    None if state is None else state["conv"])
        # Views of the conv output: the kernel reads them through their
        # strides, with no copy.
        xs, Bm, Cm = torch.split(xBC, [di, G * N, G * N], dim=-1)
        xs = xs.unflatten(-1, (H, P))
        Bm, Cm = Bm.unflatten(-1, (G, N)), Cm.unflatten(-1, (G, N))
        dt = F.softplus(dt.float() + self.dt_bias)
        a = -torch.exp(self.A_log)

        if mode == "decode":
            y, new_ssm = ssm_decode_step(state["ssm"], xs[:, 0], dt[:, 0], a,
                                         Bm[:, 0], Cm[:, 0], self.D)
            y = y[:, None]
        else:
            h0 = None if state is None else state["ssm"]
            y, new_ssm = ops.ssm_scan(xs, dt, a, Bm, Cm, self.D, h0=h0,
                                      chunk=cfg.ssm_chunk)
        y = y.reshape(B, S, di)
        y = rms_norm(y * F.silu(z.float()).to(dtype), self.norm,
                     cfg.norm_eps, plus_one=True)
        out = y.to(dtype) @ self.out_proj.to(dtype)
        new_state = None
        if mode in ("prefill", "decode"):
            cdt = new_conv.dtype if state is None else state["conv"].dtype
            new_state = {"conv": new_conv.to(cdt), "ssm": new_ssm}
        return out, new_state
