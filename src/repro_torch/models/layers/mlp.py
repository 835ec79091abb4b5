"""Dense gated MLP (SwiGLU / GeGLU) and top-k Mixture-of-Experts."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...sharding.logical import (Spec, _axes, axis_index, local_params,
                                 local_region, local_shape, mesh_of,
                                 row_parallel, rule, shard, split_axis)
from ...sharding.logical import placements as to_placements
from ...sharding.logical import sanitize_spec
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
        mesh = mesh_of(x, self.w_gate)
        if mesh is not None:
            return self._on_mesh(mesh, x, act, dtype)
        return shard(self._mlp(x, act, dtype), "act_btd")

    def _mlp(self, x, act, dtype):
        x = x.to(dtype)
        g = x @ self.w_gate.to(dtype)
        u = x @ self.w_up.to(dtype)
        h = shard(act_fn(act)(g) * u, "act_btf")
        return h @ self.w_down.to(dtype)

    def _on_mesh(self, mesh, x, act, dtype):
        """In a ``local_map`` region (PERF.md §3): x with its batch over
        the data axes and whole on ``model``, the hidden width split over
        ``model`` (w_gate and w_up by columns, w_down by rows: JAX's
        ``act_btf``), the output a partial sum over the split."""
        fs = split_axis(mesh, self.w_gate.shape[1])
        sx = sanitize_spec(Spec(rule("act_btd", mesh)[0], None, None),
                           x.shape, mesh)

        def local(xl, wg, wu, wd):
            with local_params(self, w_gate=wg, w_up=wu, w_down=wd):
                return self._mlp(xl, act, dtype)
        out = local_region(local, mesh,
                           (x, self.w_gate, self.w_up, self.w_down),
                           (sx, Spec(None, fs), Spec(None, fs),
                            Spec(fs, None)), row_parallel(sx, mesh, fs))
        return shard(out, "act_btd")


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
    left out of the products), the experts run as batched products over
    E's G·C slots (JAX's expert einsums, FLOP for FLOP), and
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

    def forward(self, x, dtype=torch.bfloat16, *,
                capacity_factor: float | None = None, group_size: int = 256):
        """x (B, S, D) → (out (B, S, D), the router's aux loss)."""
        cfg = self.cfg
        B, S, D = x.shape
        E, K = cfg.n_experts, cfg.moe_top_k
        T = B * S
        cf = capacity_factor or cfg.moe_capacity_factor
        gs = T if T <= 256 else min(group_size, T)
        ws = (self.router, self.w_gate, self.w_up, self.w_down)
        mesh = mesh_of(x, *ws)
        if mesh is None:
            out, psum, csum, n = self._experts(
                x.reshape(T, D), *ws, e0=0, n_valid=T, gs=gs, cf=cf,
                dropless=T <= 256, dtype=dtype)
            out = out[:T].reshape(B, S, D)
        else:
            out, psum, csum, n = self._on_mesh(mesh, x, ws, T, gs, cf, dtype)
        aux = ((psum / n) * (csum / (n * K))).sum() * E
        if cfg.n_shared_experts:
            out = out + self.shared(x.to(dtype), cfg.act, dtype)
        return shard(out, "act_btd"), aux

    def _on_mesh(self, mesh, x, ws, T, gs, cf, dtype):
        """The routed experts in a ``local_map`` region (PERF.md §3): the
        router whole; the experts split over ``model`` (EP, JAX's
        ``moe_ecd``) or, when n_experts does not divide it, their FFN dim
        (JAX's fallback of ``moe_ecf``), so the output is a partial sum
        over ``model``. The tokens are JAX's groups of the global token
        order. Where a rank's tokens (x's batch over the data axes) form
        whole groups, or T ≤ 256 (one dropless group, which splits
        token by token), each rank routes its own tokens. Otherwise x
        enters whole, the groups are laid out as JAX's ``moe_gtd`` (over
        the data axes where their count divides them, else whole on every
        rank), and the output is gathered back to x's layout. The
        router's sums are partial over the mesh dims where the tokens are
        split (and over ``model``, where only rank 0 contributes them). A
        replicated weight's gradient is partial where the work is split
        (``local_region``)."""
        from torch.distributed.tensor import Partial, Replicate

        cfg = self.cfg
        E, (B, S, D) = cfg.n_experts, x.shape
        dp, model = rule("act_btd", mesh)[0], rule("moe_ecd", mesh)[1]
        sx = sanitize_spec(Spec(dp, None, None), x.shape, mesh)
        ep = sanitize_spec(Spec(model), (E,), mesh)[0]
        if ep is not None:
            sg = su = sd = Spec(ep, None, None)
        else:
            sg = su = sanitize_spec(Spec(None, None, model),
                                    self.w_gate.shape, mesh)
            sd = Spec(None, sg[2], None)
        names = list(mesh.mesh_dim_names)
        m_rank, m_size = axis_index(mesh, model)
        e0 = m_rank * (E // m_size) if ep else 0
        G = -(-T // gs)
        # the rank's own tokens (its batch rows) are whole groups of the
        # global order, or one dropless group
        own = T <= 256 or local_shape(x.shape, sx, mesh)[0] * S % gs == 0
        if own:
            xs, tok = sx, sx[0]
        else:
            # JAX's groups of the global tokens, as moe_gtd lays them out
            xs = Spec(None, None, None)
            tok = sanitize_spec(Spec(rule("moe_gtd", mesh)[0], None, None),
                                (G, gs, D), mesh)[0]
        part, n_part = axis_index(mesh, tok)
        # every model rank routes alike: the router's sums count once
        # (rank 0's), so the aux loss's gradient is not summed m times
        first = float(m_rank == 0)
        ep_split = [nm == model and bool(ep or sg[2]) for nm in names]
        rows = to_placements(sx if own else Spec(tok, None), mesh)
        out_pl = [Partial() if sp else p for sp, p in zip(ep_split, rows)]
        sums = [Partial() if nm in _axes(tok) or nm == model else Replicate()
                for nm in names]

        def local(xl, r, wg, wu, wd):
            xt = xl.reshape(-1, D)
            if own:
                n_valid, gsl = xt.shape[0], min(gs, xt.shape[0])
            else:
                n_g = G // n_part * gs            # this rank's groups
                t0 = part * n_g
                xt = F.pad(xt, (0, 0, 0, G * gs - T))[t0:t0 + n_g]
                n_valid, gsl = min(max(T - t0, 0), n_g), gs
            out, psum, csum, _ = self._experts(
                xt, r, wg, wu, wd, e0=e0, n_valid=n_valid, gs=gsl, cf=cf,
                dropless=T <= 256, dtype=dtype)
            if own:
                out = out[:n_valid].view(xl.shape)
            return out, psum * first, csum * first
        out, psum, csum = local_region(
            local, mesh, (x,) + tuple(ws),
            (xs, Spec(None, None), sg, su, sd), (out_pl, sums, sums))
        if not own:
            # the groups' outputs (G·gs, D), gathered, back in x's layout
            out = out.redistribute(mesh, [Replicate()] * len(names))[:T]
            out = out.view(B, S, D).redistribute(mesh, to_placements(sx,
                                                                     mesh))
        return out, psum, csum, G * gs

    def _experts(self, xt, router, w_gate, w_up, w_down, *, e0, n_valid,
                 gs, cf, dropless, dtype):
        """Routing of the tokens xt (N, D), the first ``n_valid`` of them
        real, in groups of ``gs`` (padded at the end to whole groups), over
        all experts, and the experts e0..e0 + w_gate.shape[0] − 1 on them
        (all of them off a mesh); ``dropless``: capacity gs·K. → (out
        (G·gs, D), the probabilities' sum over the padded tokens (E,), the
        routes' count per expert (E,), the padded token count G·gs)."""
        cfg = self.cfg
        D = xt.shape[1]
        K = cfg.moe_top_k
        El = w_gate.shape[0]
        xg = F.pad(xt.to(dtype), (0, 0, 0, (-xt.shape[0]) % gs))
        G = xg.shape[0] // gs
        probs, gate, sel, ranks, C = self.route(xg, n_valid, gs, cf, dtype,
                                                router, dropless)
        keep = ranks < C
        mine = keep & (sel >= e0) & (sel < e0 + El)
        group = torch.arange(G * gs, device=xt.device)[:, None] // gs
        slot = torch.where(mine, group * C + ranks, G * C)
        sel_l = torch.where(mine, sel - e0, 0)

        # the dump row G·C takes the dropped routes and is left out of
        # the products; a dropped route reads slot 0 at weight 0 instead
        ex_in = xg.new_zeros(El, G * C + 1, D)
        ex_in[sel_l, slot] = xg[:, None, :].expand(-1, K, -1)
        ex_in = ex_in[:, :G * C]
        h = act_fn(cfg.act)(torch.bmm(ex_in, w_gate.to(dtype))) * \
            torch.bmm(ex_in, w_up.to(dtype))
        ex_out = torch.bmm(h, w_down.to(dtype))
        w = (gate * mine).to(dtype).float()
        out = (ex_out[sel_l, torch.where(mine, slot, 0)].float()
               * w[..., None]).sum(1).to(dtype)
        psum = probs.sum(0)
        csum = F.one_hot(sel, cfg.n_experts).sum(1).float().sum(0)
        return out, psum, csum, G * gs

    def route(self, xg, T, gs, capacity_factor, dtype, router, dropless):
        """Routing of the padded tokens xg (G·gs, D), T of them real, by
        ``router``; ``dropless`` (JAX's rule, T ≤ 256 on the global token
        count): capacity gs·K. →
        (probs (G·gs, E) f32, gate values (G·gs, K) f32, experts (G·gs,
        K), ranks (G·gs, K), capacity C)."""
        E, K = self.cfg.n_experts, self.cfg.moe_top_k
        G = xg.shape[0] // gs
        probs = torch.softmax((xg @ router.to(dtype)).float(), dim=-1)
        if xg.shape[0] != T:
            probs = probs * (torch.arange(xg.shape[0], device=xg.device)
                             < T)[:, None]
        # jax.lax.top_k: descending, the lower index first among ties.
        gate, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate, sel = gate[:, :K], sel[:, :K]
        gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
        C = gs * K if dropless else max(1, int(capacity_factor * gs * K / E))
        flat = F.one_hot(sel, E).reshape(G, gs * K, E)
        ranks = ((flat.cumsum(1) - flat) * flat).sum(-1).reshape(-1, K)
        return probs, gate, sel, ranks, C
