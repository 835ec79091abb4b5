"""Shared building blocks: norms, RoPE, activations, initializers."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def rms_norm(x, scale, eps: float = 1e-5, plus_one: bool = False):
    """RMS norm computed in f32 and cast back to ``x.dtype``; with
    ``plus_one`` the stored scale is an offset from 1."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    s = (1.0 + scale.float()) if plus_one else scale.float()
    return (y * s).to(x.dtype)


def weight(*shape, dtype, device):
    """An uninitialised, frozen parameter (drawn by ``init_model`` or
    loaded from converted JAX weights)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def act_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def rope(x, positions, theta: float = 10000.0, rot_dim: int | None = None):
    """Rotary embedding. x (..., S, H, D) rotates the first ``rot_dim``
    dims (default: all), split into two halves (not interleaved pairs).
    positions (..., S) or (S,)."""
    D = x.shape[-1]
    rd = rot_dim or D
    if rd % 2:
        raise ValueError(f"rotary dim must be even, got {rd}")
    x_rot, x_pass = x[..., :rd], x[..., rd:]
    freqs = theta ** (-torch.arange(0, rd, 2, dtype=torch.float32,
                                    device=x.device) / rd)
    ang = positions.float()[..., None] * freqs            # (..., S, rd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x_rot.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


def dense_init(shape, in_axis_size: int, generator: torch.Generator,
               dtype=torch.float32, device=None):
    """Truncated-normal (±2σ) fan-in init, drawn in f32 from
    ``generator`` and cast to ``dtype``."""
    std = (1.0 / max(in_axis_size, 1)) ** 0.5
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * std).to(dtype)


def softcap(x, cap: float | None):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
