"""Dense gated MLP (SwiGLU / GeGLU) and top-k Mixture-of-Experts."""
from __future__ import annotations

import torch
import torch.nn.functional as F
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


class MoE(nn.Module):
    """Top-k routed experts with group-wise capacity, the JAX package's
    ``moe_apply``: router (D, E); w_gate, w_up (E, D, F); w_down (E, F,
    D).

    Tokens are cut into groups of ``group_size`` (one dropless group when
    T ≤ 256, capacity gs·K); each group gives every expert C = max(1,
    int(cf·gs·K/E)) slots, filled in the flattened (token, k) order, and
    a route past its expert's C is dropped. Pad tokens (zero
    probabilities, so experts 0..K−1 by the stable order of ``top_k``)
    take slots at the end of the last group. JAX dispatches through
    one-hot einsums; here each kept route is scattered into its slot of an
    (E, G·C + 1, D) buffer (the last row takes every dropped route and is
    never read back), the experts run as batched products over E, and
    each token gathers its K outputs, weighted by its gate values
    rounded to the compute dtype. The values are JAX's; nothing syncs
    with the host.

    With ``cfg.n_shared_experts`` (deepseek-v2) a dense ``MLP`` of width
    moe_d_ff · n_shared_experts, ``shared``, runs on every token in the
    (B, S, D) layout and is added after the routed combine, as in JAX."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        D, Fe, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts

        def w(*shape):
            return weight(*shape, dtype=dtype, device=device)
        self.router = w(D, E)
        self.w_gate, self.w_up, self.w_down = w(E, D, Fe), w(E, D, Fe), w(
            E, Fe, D)
        if cfg.n_shared_experts:
            self.shared = MLP(D, Fe * cfg.n_shared_experts, D, dtype, device)
        self.cfg = cfg

    def route(self, xg, T, gs, capacity_factor, dtype):
        """Routing of the padded tokens xg (G·gs, D), T of them real:
        (probs (G·gs, E) f32, gate values (G·gs, K) f32, experts (G·gs,
        K), ranks (G·gs, K), capacity C)."""
        E, K = self.cfg.n_experts, self.cfg.moe_top_k
        G = xg.shape[0] // gs
        probs = torch.softmax((xg @ self.router.to(dtype)).float(), dim=-1)
        if xg.shape[0] != T:
            probs = probs * (torch.arange(xg.shape[0], device=xg.device)
                             < T)[:, None]
        # jax.lax.top_k: descending, the lower index first among ties.
        gate, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate, sel = gate[:, :K], sel[:, :K]
        gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
        C = gs * K if T <= 256 else max(1, int(capacity_factor * gs * K / E))
        flat = F.one_hot(sel, E).reshape(G, gs * K, E)
        ranks = ((flat.cumsum(1) - flat) * flat).sum(-1).reshape(-1, K)
        return probs, gate, sel, ranks, C

    def forward(self, x, dtype=torch.bfloat16, *,
                capacity_factor: float | None = None, group_size: int = 256):
        """x (B, S, D) → (out (B, S, D), the router's aux loss)."""
        cfg = self.cfg
        B, S, D = x.shape
        E, K = cfg.n_experts, cfg.moe_top_k
        T = B * S
        cf = capacity_factor or cfg.moe_capacity_factor
        xt = x.reshape(T, D).to(dtype)
        gs = T if T <= 256 else min(group_size, T)
        xg = F.pad(xt, (0, 0, 0, (-T) % gs))
        G = xg.shape[0] // gs
        probs, gate, sel, ranks, C = self.route(xg, T, gs, cf, dtype)
        keep = ranks < C
        group = torch.arange(G * gs, device=x.device)[:, None] // gs
        slot = torch.where(keep, group * C + ranks, G * C)

        ex_in = xg.new_zeros(E, G * C + 1, D)
        ex_in[sel, slot] = xg[:, None, :].expand(-1, K, -1)
        h = act_fn(cfg.act)(torch.bmm(ex_in, self.w_gate.to(dtype))) * \
            torch.bmm(ex_in, self.w_up.to(dtype))
        ex_out = torch.bmm(h, self.w_down.to(dtype))
        w = (gate * keep).to(dtype).float()
        out = (ex_out[sel, slot].float() * w[..., None]).sum(1).to(dtype)

        me = probs.mean(0)
        ce = F.one_hot(sel, E).sum(1).float().mean(0) / K
        aux = (me * ce).sum() * E
        out = out[:T].reshape(B, S, D)
        if cfg.n_shared_experts:
            out = out + self.shared(x.to(dtype), cfg.act, dtype)
        return out, aux
