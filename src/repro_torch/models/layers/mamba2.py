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
from ...sharding.logical import (Spec, gather_dim, local_params,
                                 local_region, mesh_of, placements,
                                 row_parallel, rule, sanitize_spec, shard,
                                 split_axis)
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
        conv0 = None if state is None else state["conv"]
        h0 = None if state is None else state["ssm"]
        mesh = mesh_of(x, self.in_proj)
        if mesh is None:
            y, z, new_conv, new_ssm = self._mix(x, conv0, h0, mode, dtype)
        else:
            y, z, new_conv, new_ssm = self._mix_on_mesh(mesh, x, conv0, h0,
                                                        mode, dtype)
        y = y.reshape(B, S, -1)
        y = rms_norm(y * F.silu(z.float()).to(dtype), self.norm,
                     cfg.norm_eps, plus_one=True)
        out = (y.to(dtype) @ self.out_proj.to(dtype) if mesh is None else
               self._out_on_mesh(mesh, y, dtype))
        new_state = None
        if mode in ("prefill", "decode"):
            cdt = new_conv.dtype if state is None else state["conv"].dtype
            new_state = {"conv": new_conv.to(cdt), "ssm": new_ssm}
        return shard(out, "act_btd"), new_state

    def _mix(self, x, conv0, h0, mode, dtype, cols=None):
        """in_proj, the causal conv and the SSD → (y (B, S, H, P), z (B,
        S, H·P), the conv's last rows, the SSD state); the heads from
        ``D`` (a shard's on a mesh, where ``cols`` picks the shard's
        columns of the whole in_proj, conv_w and conv_b, and the conv
        state's channels)."""
        cfg = self.cfg
        N = cfg.ssm_state
        H = self.D.shape[0]
        P = cfg.ssm_head_dim
        di = H * P
        w, cw, cb = self.in_proj, self.conv_w, self.conv_b
        if cols is not None:
            proj, conv = cols
            w, cw, cb = w[:, proj], cw[:, conv], cb[conv]
            conv0 = None if conv0 is None else conv0[..., conv]
        zxbcdt = x.to(dtype) @ w.to(dtype)
        z, xBC, dt = torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)
        xBC = shard(xBC, "act_bti")
        xBC, new_conv = causal_conv(xBC, cw.to(dtype), cb.to(dtype), conv0)
        # Views of the conv output: the kernel reads them through their
        # strides, with no copy.
        xs, Bm, Cm = torch.split(xBC, [di, G * N, G * N], dim=-1)
        xs = xs.unflatten(-1, (H, P))
        Bm, Cm = Bm.unflatten(-1, (G, N)), Cm.unflatten(-1, (G, N))
        dt = F.softplus(dt.float() + self.dt_bias)
        a = -torch.exp(self.A_log)

        if mode == "decode":
            y, new_ssm = ops.ssm_step(h0, xs[:, 0], dt[:, 0], a, Bm[:, 0],
                                      Cm[:, 0], self.D)
            y = y[:, None]
        else:
            y, new_ssm = ops.ssm_scan(xs, dt, a, Bm, Cm, self.D, h0=h0,
                                      chunk=cfg.ssm_chunk)
        return y, z, new_conv, new_ssm

    def _mix_on_mesh(self, mesh, x, conv0, h0, mode, dtype):
        """``_mix`` in a ``local_map`` region (PERF.md §3): x with its
        batch over the data axes and whole on ``model``; the heads split
        over ``model`` when it divides them. in_proj, conv_w and conv_b
        are **gathered whole** (their columns interleave z, x, B, C and
        dt, so a contiguous split does not follow the heads) and each rank
        takes its heads' columns and the shared B and C ones; the conv
        state whole, its x channels leaving the region split and B, C
        whole."""
        cfg = self.cfg
        H, P, N = self.D.shape[0], cfg.ssm_head_dim, cfg.ssm_state
        di = H * P
        hs = split_axis(mesh, H)
        sx = sanitize_spec(Spec(rule("act_btd", mesh)[0], None, None),
                           x.shape, mesh)
        dp = sx[0]
        names = list(mesh.mesh_dim_names)
        parts = mesh.shape[names.index(hs)] if hs else 1

        def local(xl, c0, s0, w, cw, cb, dt_bias, a_log, d):
            r = (mesh.get_coordinate() or [0] * len(names))[
                names.index(hs)] if hs else 0
            hl = H // parts
            own = torch.arange(r * hl * P, (r + 1) * hl * P,
                               device=xl.device)
            shared = torch.arange(di, di + 2 * G * N, device=xl.device)
            proj = torch.cat([own, di + own, di + shared,
                              2 * di + 2 * G * N + r * hl
                              + torch.arange(hl, device=xl.device)])
            conv = torch.cat([own, shared])
            with local_params(self, in_proj=w, conv_w=cw, conv_b=cb,
                              dt_bias=dt_bias, A_log=a_log, D=d):
                y, z, c, s = self._mix(xl, c0, s0, mode, dtype,
                                       cols=(proj, conv))
            return y, z, c[..., :hl * P], c[..., hl * P:], s
        heads = Spec(hs)
        y, z, cx, cbc, s = local_region(
            local, mesh,
            (x, conv0, h0, self.in_proj, self.conv_w, self.conv_b,
             self.dt_bias, self.A_log, self.D),
            (sx, None if conv0 is None else Spec(dp, None, None),
             None if h0 is None else Spec(dp, hs, None, None),
             Spec(None, None), Spec(None, None), Spec(None), heads, heads,
             heads),
            (placements(Spec(dp, None, hs, None), mesh),
             placements(Spec(dp, None, hs), mesh),
             placements(Spec(dp, None, hs), mesh),
             placements(Spec(dp, None, None), mesh),
             placements(Spec(dp, hs, None, None), mesh)))
        return y, z, torch.cat([gather_dim(cx, 2), cbc], dim=2), s

    def _out_on_mesh(self, mesh, y, dtype):
        """out_proj in a region: y split over the heads as
        ``_mix_on_mesh`` left them, out_proj's rows alike; the output a
        partial sum over the split."""
        hs = split_axis(mesh, self.D.shape[0])
        sy = sanitize_spec(Spec(rule("act_btd", mesh)[0], None, hs),
                           y.shape, mesh)

        def local(yl, w):
            return yl.to(dtype) @ w.to(dtype)
        return local_region(local, mesh, (y, self.out_proj),
                            (sy, Spec(hs, None)),
                            row_parallel(Spec(sy[0], None, None), mesh, hs))
