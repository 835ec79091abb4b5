"""Dense gated MLP (SwiGLU / GeGLU)."""
from __future__ import annotations

import torch
from torch import nn

from .common import act_fn, weight


class MLP(nn.Module):
    """w_gate (D, F), w_up (D, F), w_down (F, D_out); the JAX package's
    ``mlp_apply``."""

    def __init__(self, d_in: int, d_ff: int, d_out: int, dtype, device):
        super().__init__()
        self.w_gate = weight(d_in, d_ff, dtype=dtype, device=device)
        self.w_up = weight(d_in, d_ff, dtype=dtype, device=device)
        self.w_down = weight(d_ff, d_out, dtype=dtype, device=device)

    def forward(self, x, act: str = "silu", dtype=torch.bfloat16):
        x = x.to(dtype)
        g = x @ self.w_gate.to(dtype)
        u = x @ self.w_up.to(dtype)
        return (act_fn(act)(g) * u) @ self.w_down.to(dtype)
