"""Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3), absorbed form:
the JAX package's ``mla_apply``.

The cache keeps only the compressed latent ``c_kv`` (kv_lora_rank) and
the decoupled RoPE key (qk_rope_dim). W^UK is absorbed into the query,
so attention is MQA in the latent space with key width kv_lora + rope
and value width kv_lora:

    q_abs = q_nope · W^UK          (B, S, H, kv_lora)
    score = (q_abs·c_kv + q_rope·k_rope) / sqrt(qk_nope + qk_rope)
    ctx   = softmax(score) · c_kv  (B, S, H, kv_lora)
    out   = (ctx · W^UV) · W^O

Train and prefill attend through ``ops.attention`` (the CUDA flash
kernel on the card, at minicpm3-4b's Dk 288 / Dv 256 and deepseek-v2's
Dk 576 / Dv 512, whose value columns the kernel splits into two slices
of 256); the value is a view of the key's first kv_lora columns. Decode
attends one token over the ring-buffer latent cache in plain PyTorch, as
the JAX layer's einsums do. The cache tensors are written in place.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn

from ...kernels.flash_attention import ops
from ...sharding.logical import (Spec, local_params, local_region, mesh_of,
                                 placements, row_parallel, rule,
                                 sanitize_spec, shard, split_axis)
from .attention import NEG_INF, _ring_positions
from .cache import prefill_cache, sharded_decode, write_slot
from .common import rms_norm, rope, weight


class MLA(nn.Module):
    """wq_a (D, q_lora), q_a_norm (q_lora,), wq_b (q_lora, H, nope + rope)
    (or wq (D, H, nope + rope) when q_lora_rank is 0); wkv_a (D, kv_lora +
    rope), kv_a_norm (kv_lora,); wk_b (kv_lora, H, nope), wv_b (kv_lora,
    H, v_head); wo (H, v_head, D). The norm scales stay f32."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        D, H = cfg.d_model, cfg.n_heads
        r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim

        def w(*shape):
            return weight(*shape, dtype=dtype, device=device)
        if r_q:
            self.wq_a = w(D, r_q)
            self.q_a_norm = weight(r_q, dtype=torch.float32, device=device)
            self.wq_b = w(r_q, H, dn + dr)
        else:
            self.wq = w(D, H, dn + dr)
        self.wkv_a = w(D, r_kv + dr)
        self.kv_a_norm = weight(r_kv, dtype=torch.float32, device=device)
        self.wk_b, self.wv_b = w(r_kv, H, dn), w(r_kv, H, dv)
        self.wo = w(H, dv, D)
        self.cfg = cfg

    def _latents(self, x, positions, dtype):
        """q_abs (B, S, H, kv_lora), q_rope (B, S, H, rope), c_kv (B, S,
        kv_lora), k_rope (B, S, rope)."""
        cfg = self.cfg
        dn, r_kv = cfg.qk_nope_dim, cfg.kv_lora_rank
        if cfg.q_lora_rank:
            qa = rms_norm(x @ self.wq_a.to(dtype), self.q_a_norm,
                          cfg.norm_eps, plus_one=True)
            q = torch.einsum("bsr,rhk->bshk", qa, self.wq_b.to(dtype))
        else:
            q = torch.einsum("bsd,dhk->bshk", x, self.wq.to(dtype))
        q_nope, q_rope = q[..., :dn], q[..., dn:]
        q_rope = rope(q_rope, positions, cfg.rope_theta)
        q_abs = torch.einsum("bshn,rhn->bshr", q_nope, self.wk_b.to(dtype))
        kv = x @ self.wkv_a.to(dtype)
        c_kv = rms_norm(kv[..., :r_kv], self.kv_a_norm, cfg.norm_eps,
                        plus_one=True)
        k_rope = rope(kv[..., r_kv:][:, :, None, :], positions,
                      cfg.rope_theta)[:, :, 0, :]
        return q_abs, q_rope, c_kv, k_rope

    def forward(self, x, *, positions, cache=None, pos=None, mode="train",
                dtype=torch.bfloat16):
        """x (B, S, D) → (out (B, S, D), cache {"ckv", "krope"})."""
        cfg = self.cfg
        B, S, _ = x.shape
        scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
        if mode in ("train", "prefill"):
            if mode == "prefill" and S > cache["ckv"].shape[1]:
                raise ValueError(f"MLA prefill of {S} tokens into a "
                                 f"cache of {cache['ckv'].shape[1]}")
            if mesh_of(x, self.wo) is not None:
                out, c_kv, k_rope = self._on_mesh(x, positions, dtype)
            else:
                out, c_kv, k_rope = self._attend(x, positions, dtype)
            if mode == "prefill":
                cache["ckv"] = shard(prefill_cache(cache["ckv"], c_kv),
                                     "cache_mla")
                cache["krope"] = prefill_cache(cache["krope"], k_rope)
            return shard(out, "act_btd"), cache
        mesh = mesh_of(x, self.wo)
        if mesh is not None:
            q_abs, q_rope, c_kv, k_rope = self._latents_on_mesh(
                mesh, x, positions, dtype)
        else:
            q_abs, q_rope, c_kv, k_rope = self._latents(x.to(dtype),
                                                        positions, dtype)
        if mode == "decode":
            ckv, krp = cache["ckv"], cache["krope"]
            capacity = ckv.shape[1]
            slot = pos % capacity
            ckv = cache["ckv"] = shard(write_slot(ckv, c_kv, slot),
                                       "cache_mla")
            krp = cache["krope"] = write_slot(krp, k_rope, slot)
            if mesh_of(q_abs, ckv) is not None:
                ctx = sharded_decode(functools.partial(
                    _decode_partial, pos=pos, capacity=capacity,
                    scale=scale), (q_abs, q_rope), (ckv, krp)).to(dtype)
            else:
                abs_pos = _ring_positions(capacity, pos, x.device)
                valid = (abs_pos >= 0) & (abs_pos <= pos)
                ckv32 = ckv.float()
                s = (torch.einsum("bqhr,bsr->bhqs", q_abs.float(), ckv32)
                     + torch.einsum("bqhr,bsr->bhqs", q_rope.float(),
                                    krp.float())) * scale
                s = torch.where(valid, s, NEG_INF)
                p = torch.softmax(s, dim=-1)
                ctx = torch.einsum("bhqs,bsr->bqhr", p, ckv32).to(dtype)
        else:
            raise ValueError(mode)
        if mesh is not None:
            return shard(self._out_on_mesh(mesh, ctx, dtype), "act_btd"), \
                cache
        return shard(self._out(ctx, dtype), "act_btd"), cache

    def _attend(self, x, positions, dtype, split=None):
        """Train and prefill: (out (B, S, D), c_kv, k_rope), MQA in the
        latent space through ``ops.attention``; with ``split`` (an
        ``ops.RowSplit``) only this rank's rows of each query chunk, the
        output's rows as ``ops.rows_attention`` orders them."""
        cfg = self.cfg
        r_kv = cfg.kv_lora_rank
        scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
        q_abs, q_rope, c_kv, k_rope = self._latents(x.to(dtype), positions,
                                                    dtype)
        q_cat = torch.cat([q_abs, q_rope], dim=-1)
        k_cat = torch.cat([c_kv, k_rope], dim=-1)[:, :, None, :]
        kw = dict(causal=True, scale=scale, q_chunk=cfg.attn_chunk,
                  kv_chunk=2 * cfg.attn_chunk)
        if split is None:
            ctx = ops.attention(q_cat, k_cat, k_cat[..., :r_kv], **kw)
        else:
            ctx = ops.rows_attention(q_cat, k_cat, k_cat[..., :r_kv], split,
                                     **kw)
        return self._out(ctx, dtype), c_kv, k_rope

    def _out(self, ctx, dtype):
        B, S = ctx.shape[:2]
        v = torch.einsum("bshr,rhv->bshv", ctx.to(dtype), self.wv_b.to(dtype))
        return v.reshape(B, S, -1) @ self.wo.to(dtype).reshape(
            -1, self.wo.shape[-1])

    def _region(self, mesh, fn, args, arg_specs, names, out_placements,
                hs):
        """``fn(*args)`` with this layer's parameters ``names`` in a
        ``local_map`` region (PERF.md §3): the heads split over ``hs``
        (wq_b or wq, wk_b, wv_b, wo; None: whole), the low-rank
        projections and their norms whole."""
        heads = Spec(None, hs, None)
        specs = {"wq_a": Spec(None, None), "q_a_norm": Spec(None),
                 "wq_b": heads, "wq": heads, "wkv_a": Spec(None, None),
                 "kv_a_norm": Spec(None), "wk_b": heads, "wv_b": heads,
                 "wo": Spec(hs, None, None)}
        names = [n for n in names if n in self._parameters]
        n = len(args)

        def local(*a):
            with local_params(self, **dict(zip(names, a[n:]))):
                return fn(*a[:n])
        return local_region(
            local, mesh, (*args, *(self._parameters[k] for k in names)),
            (*arg_specs, *(specs[k] for k in names)), out_placements)

    def _on_mesh(self, x, positions, dtype):
        """``_attend`` in a region: x with its batch over the data axes
        and whole on ``model``; the output a partial sum over the heads'
        split, the latents whole. Where the rules hold ``attn_qchunk``,
        the heads stay whole and the rows of each query chunk are split
        over the rule's axes instead (``ops.row_region``): each rank
        attends and projects its rows, which come back in sequence
        order."""
        mesh = mesh_of(x, self.wo)
        sx = sanitize_spec(Spec(rule("act_btd", mesh)[0], None, None),
                           x.shape, mesh)
        whole = placements(Spec(sx[0], None, None), mesh)

        def region(split, hs, out_pl):
            return self._region(
                mesh, lambda xl, p: self._attend(xl, p, dtype, split),
                (x, positions), (sx, Spec(None, None)), list(_WEIGHTS),
                (out_pl, whole, whole), hs)
        res = ops.row_region(mesh, sx[0], x.shape, self.cfg.attn_chunk,
                             lambda split, pl: region(split, None, pl))
        if res is not None:
            return res
        hs = split_axis(mesh, self.wo.shape[0])
        return region(None, hs, row_parallel(sx, mesh, hs))

    def _latents_on_mesh(self, mesh, x, positions, dtype):
        """Decode's ``_latents`` in a region: the queries' heads split as
        the weights', the latents whole."""
        hs = split_axis(mesh, self.wo.shape[0])
        sx = sanitize_spec(Spec(rule("act_btd", mesh)[0], None, None),
                           x.shape, mesh)
        q = placements(Spec(sx[0], None, hs, None), mesh)
        whole = placements(Spec(sx[0], None, None), mesh)
        # decode's positions (B, 1) split as x's batch; (1, S) whole
        sp = Spec(sx[0] if positions.shape[0] > 1 else None, None)
        return self._region(
            mesh, lambda xl, p: self._latents(xl.to(dtype), p, dtype),
            (x, positions), (sx, sp),
            [k for k in _WEIGHTS if k not in ("wv_b", "wo")],
            (q, q, whole, whole), hs)

    def _out_on_mesh(self, mesh, ctx, dtype):
        """``_out`` in a region: ctx's heads split as wv_b's and wo's,
        the output a partial sum over the split."""
        hs = split_axis(mesh, self.wo.shape[0])
        sc = sanitize_spec(Spec(rule("act_btd", mesh)[0], None, hs, None),
                           ctx.shape, mesh)
        return self._region(
            mesh, lambda c: self._out(c, dtype), (ctx,), (sc,),
            ["wv_b", "wo"],
            row_parallel(Spec(sc[0], None, None), mesh, hs), hs)


# MLA's parameters, in the order the regions pass them.
_WEIGHTS = ("wq_a", "q_a_norm", "wq_b", "wq", "wkv_a", "kv_a_norm", "wk_b",
            "wv_b", "wo")


def _decode_partial(q_abs, q_rope, ckv, krp, c0, *, pos, capacity, scale):
    """MLA's decode attention over the slots c0.. of one latent-cache
    shard → (acc, m, l) for ``sharded_decode``."""
    slots = c0 + torch.arange(ckv.shape[1], device=ckv.device)
    abs_pos = pos - torch.remainder(pos - slots, capacity)
    valid = (abs_pos >= 0) & (abs_pos <= pos)
    ckv32 = ckv.float()
    s = (torch.einsum("bqhr,bsr->bhqs", q_abs.float(), ckv32)
         + torch.einsum("bqhr,bsr->bhqs", q_rope.float(),
                        krp.float())) * scale
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    acc = torch.einsum("bhqs,bsr->bqhr", p, ckv32)
    return acc, m[..., 0].transpose(1, 2), p.sum(-1).transpose(1, 2)
