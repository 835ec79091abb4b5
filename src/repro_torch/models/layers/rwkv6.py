"""RWKV-6 (Finch) block parts: data-dependent token-shift mixing, the WKV
recurrence with per-channel data-dependent decay, and the squared-ReLU
channel mix (the JAX package's ``models/layers/rwkv6.py``).

Decode state per block: the last hidden token for each of the two token
shifts, in the cache dtype, and the WKV state (B, H, K, K) in f32 — a
constant size whatever the context. Prefill runs the WKV through
``ops.wkv6`` (the CUDA kernel on the card, the plain chunked version on
the CPU); decode runs the plain single-step update, as in JAX.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...kernels.rwkv6 import ops
from ...sharding.logical import (Spec, local_params, local_region, mesh_of,
                                 placements, row_parallel, rule,
                                 sanitize_spec, shard, split_axis)
from .common import weight

_MIX = ("r", "k", "v", "g", "w")


def init_rwkv_state(cfg, batch: int, dtype, device):
    """One block's serving state: {"shift_t", "shift_c": (B, D) in
    ``dtype``, "wkv": (B, H, K, K) f32}, all zero."""
    D, H, K = cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_dim
    return {"shift_t": torch.zeros((batch, D), dtype=dtype, device=device),
            "shift_c": torch.zeros((batch, D), dtype=dtype, device=device),
            "wkv": torch.zeros((batch, H, K, K), dtype=torch.float32,
                               device=device)}


def token_shift(x, last):
    """x (B,S,D) → previous token (B,S,D); ``last`` (B,D) seeds
    position 0."""
    return torch.cat([last[:, None, :].to(x.dtype), x[:, :-1]], dim=1)


class TimeMix(nn.Module):
    """The decay LoRA (``w0``, ``decay_A``, ``decay_B``), the bonus ``u``
    and the output scale ``ln_x`` are f32, as the JAX layer computes with
    them; every other weight is stored in the compute dtype."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        D, m, r = cfg.d_model, cfg.rwkv_mix_lora, cfg.rwkv_decay_lora
        f32 = torch.float32
        self.mu_base = weight(len(_MIX), D, dtype=dtype, device=device)
        self.mix_A = weight(D, len(_MIX) * m, dtype=dtype, device=device)
        self.mix_B = weight(len(_MIX), m, D, dtype=dtype, device=device)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, weight(D, D, dtype=dtype, device=device))
        self.w0 = weight(D, dtype=f32, device=device)
        self.decay_A = weight(D, r, dtype=f32, device=device)
        self.decay_B = weight(r, D, dtype=f32, device=device)
        self.u = weight(cfg.rwkv_heads, cfg.rwkv_head_dim, dtype=f32,
                        device=device)
        self.ln_x = weight(D, dtype=f32, device=device)
        self.cfg = cfg

    def forward(self, x, *, state=None, mode="train", dtype=torch.bfloat16):
        """x (B,S,D) → (out (B,S,D), new state {"shift_t", "wkv"} in
        prefill/decode, else None)."""
        cfg = self.cfg
        B, S, D = x.shape
        x = x.to(dtype)
        last = (torch.zeros((B, D), dtype=dtype, device=x.device)
                if state is None else state["shift_t"])
        s0 = None if state is None else state["wkv"]
        mesh = mesh_of(x, self.wr)
        if mesh is None:
            y, g, new_wkv = self._mix(x, last, s0, mode, dtype)
        else:
            y, g, new_wkv = self._mix_on_mesh(mesh, x, last, s0, mode, dtype)
        # rms over D, then a plain scale by ln_x (not an offset from 1)
        y32 = y.reshape(B, S, D).float()
        y = (y32 * torch.rsqrt((y32 * y32).mean(-1, keepdim=True)
                               + cfg.norm_eps) * self.ln_x).to(dtype)
        if mesh is None:
            out = self._out(y, g, dtype)
        else:
            out = self._out_on_mesh(mesh, y, g, dtype)
        new_state = None
        if mode in ("prefill", "decode"):
            sdt = x.dtype if state is None else state["shift_t"].dtype
            new_state = {"shift_t": x[:, -1].to(sdt), "wkv": new_wkv}
        return shard(out, "act_btd"), new_state

    def _mix(self, x, last, s0, mode, dtype):
        """The token-shift mixes, the projections and the WKV → (y (B, S,
        H, K), g (B, S, H·K), new WKV state); the heads from ``u`` (a
        shard's on a mesh)."""
        B, S, D = x.shape
        H, K = self.u.shape
        dxp = token_shift(x, last) - x
        # data-dependent mixing (LoRA over the 5 mixes)
        lora = torch.tanh((x + 0.5 * dxp) @ self.mix_A.to(dtype))
        lora = lora.reshape(B, S, len(_MIX), -1)
        mix = (self.mu_base.to(dtype)[None, None]
               + torch.einsum("bsnm,nmd->bsnd", lora, self.mix_B.to(dtype)))
        xm = x[:, :, None, :] + dxp[:, :, None, :] * mix     # (B,S,5,D)
        xr, xk, xv, xg, xw = xm.unbind(dim=2)

        r = xr @ self.wr.to(dtype)
        k = xk @ self.wk.to(dtype)
        v = xv @ self.wv.to(dtype)
        g = xg @ self.wg.to(dtype)
        ww = self.w0 + (xw.float() @ self.decay_A) @ self.decay_B
        # w is rounded to the compute dtype before the WKV, as in JAX
        w = torch.exp(-torch.exp(ww)).to(dtype)              # (0, 1)

        rh, kh, vh, wh = (t.reshape(B, S, H, K) for t in (r, k, v, w))
        if mode == "decode":
            y, new_wkv = ops.wkv6_step(s0, rh[:, 0], kh[:, 0], vh[:, 0],
                                       wh[:, 0], self.u)
            y = y[:, None]
        else:
            y, new_wkv = ops.wkv6(rh, kh, vh, wh, self.u, s0=s0,
                                  chunk=self.cfg.ssm_chunk)
        return y, g, new_wkv

    def _out(self, y, g, dtype):
        return (y * F.silu(g)) @ self.wo.to(dtype)

    def _mix_on_mesh(self, mesh, x, last, s0, mode, dtype):
        """``_mix`` in a ``local_map`` region (PERF.md §3): x and the
        shifted token with their batch over the data axes and whole on
        ``model``; the heads split over ``model`` when it divides them
        (the projections' columns, w0, decay_B's columns, u), the mixes
        and decay_A whole."""
        H = self.u.shape[0]
        hs = split_axis(mesh, H)
        sx = sanitize_spec(Spec(rule("act_btd", mesh)[0], None, None),
                           x.shape, mesh)
        dp = sx[0]
        cols = Spec(None, hs)
        names = ("mu_base", "mix_A", "mix_B", "wr", "wk", "wv", "wg", "w0",
                 "decay_A", "decay_B", "u")
        specs = (Spec(None, None), Spec(None, None), Spec(None, None, None),
                 cols, cols, cols, cols, Spec(hs), Spec(None, None), cols,
                 Spec(hs, None))

        def local(xl, ll, sl, *ws):
            with local_params(self, **dict(zip(names, ws))):
                return self._mix(xl, ll, sl, mode, dtype)
        return local_region(
            local, mesh, (x, last, s0, *(self._parameters[n] for n in names)),
            (sx, Spec(dp, None),
             None if s0 is None else Spec(dp, hs, None, None), *specs),
            (placements(Spec(dp, None, hs, None), mesh),
             placements(Spec(dp, None, hs), mesh),
             placements(Spec(dp, hs, None, None), mesh)))

    def _out_on_mesh(self, mesh, y, g, dtype):
        """``_out`` in a region: y and g split over the heads as
        ``_mix_on_mesh`` left them, wo's rows alike; the output a partial
        sum over the split."""
        hs = split_axis(mesh, self.u.shape[0])
        sy = sanitize_spec(Spec(rule("act_btd", mesh)[0], None, hs),
                           y.shape, mesh)

        def local(yl, gl, wo):
            with local_params(self, wo=wo):
                return self._out(yl, gl, dtype)
        return local_region(local, mesh, (y, g, self.wo),
                            (sy, sy, Spec(hs, None)),
                            row_parallel(Spec(sy[0], None, None), mesh, hs))


class ChannelMix(nn.Module):
    """Squared-ReLU channel mix with a sigmoid receptance gate."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        D, Fd = cfg.d_model, cfg.d_ff
        self.cmix_mu = weight(2, D, dtype=dtype, device=device)
        self.ck = weight(D, Fd, dtype=dtype, device=device)
        self.cv = weight(Fd, D, dtype=dtype, device=device)
        self.cr = weight(D, D, dtype=dtype, device=device)

    def forward(self, x, *, state=None, mode="train", dtype=torch.bfloat16):
        """x (B,S,D) → (out (B,S,D), new state {"shift_c"} in
        prefill/decode, else None)."""
        B, S, D = x.shape
        x = x.to(dtype)
        last = (torch.zeros((B, D), dtype=dtype, device=x.device)
                if state is None else state["shift_c"])
        mesh = mesh_of(x, self.ck)
        out = (self._mix(x, last, dtype) if mesh is None else
               self._on_mesh(mesh, x, last, dtype))
        new_state = None
        if mode in ("prefill", "decode"):
            sdt = x.dtype if state is None else state["shift_c"].dtype
            new_state = {"shift_c": x[:, -1].to(sdt)}
        return shard(out, "act_btd"), new_state

    def _mix(self, x, last, dtype):
        dxp = token_shift(x, last) - x
        mu = self.cmix_mu.to(dtype)
        xk = x + dxp * mu[0]
        xr = x + dxp * mu[1]
        k = torch.square(torch.relu(xk @ self.ck.to(dtype)))
        v = shard(k, "act_btf") @ self.cv.to(dtype)
        r = torch.sigmoid(xr @ self.cr.to(dtype))
        return r * v

    def _on_mesh(self, mesh, x, last, dtype):
        """``_mix`` in a ``local_map`` region (PERF.md §3): x with its
        batch over the data axes and whole on ``model``, the hidden width
        split over ``model`` (ck by columns, cv by rows: JAX's
        ``act_btf``), cr **whole**; r · (k · cv) is linear in the split,
        so the output is a partial sum over it."""
        fs = split_axis(mesh, self.ck.shape[1])
        sx = sanitize_spec(Spec(rule("act_btd", mesh)[0], None, None),
                           x.shape, mesh)

        def local(xl, ll, mu, ck, cv, cr):
            with local_params(self, cmix_mu=mu, ck=ck, cv=cv, cr=cr):
                return self._mix(xl, ll, dtype)
        return local_region(
            local, mesh, (x, last, self.cmix_mu, self.ck, self.cv, self.cr),
            (sx, Spec(sx[0], None), Spec(None, None), Spec(None, fs),
             Spec(fs, None), Spec(None, None)), row_parallel(sx, mesh, fs))
