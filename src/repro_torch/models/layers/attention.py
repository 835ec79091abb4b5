"""GQA attention layer with train / prefill / decode paths.

The KV cache is a ring buffer of capacity ``C`` (= window size for
sliding-window archs, = max context otherwise). RoPE is applied to keys
before caching, so ring rotation only affects masking, which is computed
from reconstructed absolute slot positions.

Prefill and train attention go through ``ops.attention``: the CUDA
flash kernel on the card, the plain blockwise version on the CPU.
Decode attends one token over the whole cache in plain PyTorch.

Unlike the JAX layer, which returns new cache arrays, this one writes
the cache tensors in place (one slot per decode step instead of a copy
of the cache) and returns the same dict.
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
from .cache import prefill_cache, sharded_decode, write_slot
from .common import rope, softcap, weight

NEG_INF = -2.0e38


def _ring_positions(capacity: int, pos: int, device):
    """Absolute position held by each cache slot after writing ``pos``."""
    s = torch.arange(capacity, device=device)
    return pos - torch.remainder(pos - s, capacity)


def _decode_attend(q, ck, cv, pos, capacity, window, cap):
    """Single-token attention over a ring-buffer cache; on a mesh, over
    the shards of a cache split along its slots (``sharded_decode``)."""
    if mesh_of(q, ck, cv) is not None:
        return sharded_decode(functools.partial(
            _decode_partial, pos=pos, capacity=capacity, window=window,
            cap=cap), (q,), (ck, cv)).to(q.dtype)
    B, S, H, Dh = q.shape               # S == 1
    KV = ck.shape[2]
    G = H // KV
    abs_pos = _ring_positions(capacity, pos, q.device)
    valid = (abs_pos >= 0) & (abs_pos <= pos)
    if window is not None:
        valid &= abs_pos > pos - window
    qg = q.reshape(B, S, KV, G, Dh).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, ck.float()) / math.sqrt(Dh)
    s = softcap(s, cap)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, cv.float())
    return out.reshape(B, S, H, cv.shape[-1]).to(q.dtype)


def _decode_partial(q, ck, cv, c0, *, pos, capacity, window, cap):
    """``_decode_attend`` over the slots c0.. of one cache shard →
    (acc, m, l) for ``sharded_decode``."""
    B, S, H, Dh = q.shape
    KV = ck.shape[2]
    G = H // KV
    slots = c0 + torch.arange(ck.shape[1], device=q.device)
    abs_pos = pos - torch.remainder(pos - slots, capacity)
    valid = (abs_pos >= 0) & (abs_pos <= pos)
    if window is not None:
        valid &= abs_pos > pos - window
    qg = q.reshape(B, S, KV, G, Dh).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, ck.float()) / math.sqrt(Dh)
    s = softcap(s, cap)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    acc = torch.einsum("bkgqs,bskd->bqkgd", p, cv.float())
    return (acc.reshape(B, S, H, cv.shape[-1]),
            m[..., 0].permute(0, 3, 1, 2).reshape(B, S, H),
            p.sum(-1).permute(0, 3, 1, 2).reshape(B, S, H))


class Attention(nn.Module):
    """wq (D_in, H, Dh), wk/wv (D_in, KV, Dh), wo (H, Dh, D_out);
    ``d_in`` and ``d_out`` default to ``cfg.d_model``, as in the JAX
    package's ``init_attn``."""

    def __init__(self, cfg, dtype, device, d_in: int | None = None,
                 d_out: int | None = None):
        super().__init__()
        D, H, KV, Dh = (d_in or cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.d_head)

        def w(*shape):
            return weight(*shape, dtype=dtype, device=device)
        self.wq, self.wk, self.wv = w(D, H, Dh), w(D, KV, Dh), w(D, KV, Dh)
        self.wo = w(H, Dh, d_out or cfg.d_model)
        self.cfg = cfg

    def forward(self, x, *, positions, window=None, cache=None, pos=None,
                mode="train", causal=True, dtype=torch.bfloat16):
        """x (B, S, D) → (out (B, S, D), cache); ``causal=False`` for an
        encoder (hubert-xlarge)."""
        if mode != "decode" and mesh_of(x, self.wq) is not None:
            return self._on_mesh(x, positions, window, cache, mode, causal,
                                 dtype)
        cfg = self.cfg
        B, S, _ = x.shape
        q, k, v = self._qkv(x, positions, dtype)

        cap = cfg.attn_logit_softcap
        if mode in ("train", "prefill"):
            if mode == "prefill":
                for n, t in (("k", k), ("v", v)):
                    cache[n] = shard(prefill_cache(cache[n], t), "cache")
            out = self._attend(q, k, v, window, causal)
        elif mode == "decode":
            capacity = cache["k"].shape[1]
            slot = pos % capacity
            # In-place write of this step's entry into its ring slot.
            for n, t in (("k", k), ("v", v)):
                cache[n] = shard(write_slot(cache[n], t, slot), "cache")
            out = _decode_attend(q, cache["k"], cache["v"], pos, capacity,
                                 window, cap)
        else:
            raise ValueError(mode)
        return shard(self._out(out, dtype), "act_btd"), cache

    def _qkv(self, x, positions, dtype):
        """q (B, S, H, Dh), k and v (B, S, KV, Dh), RoPE applied; the
        head counts from the weights (a shard's on a mesh)."""
        B, S, D = x.shape
        H, Dh = self.wq.shape[1:]
        KV = self.wk.shape[1]
        xq = x.to(dtype)
        q = (xq @ self.wq.to(dtype).reshape(D, H * Dh)).view(B, S, H, Dh)
        k = (xq @ self.wk.to(dtype).reshape(D, KV * Dh)).view(B, S, KV, Dh)
        v = (xq @ self.wv.to(dtype).reshape(D, KV * Dh)).view(B, S, KV, Dh)
        q = rope(q, positions, self.cfg.rope_theta)
        k = rope(k, positions, self.cfg.rope_theta)
        return shard(q, "act_bshd"), k, v

    def _attend(self, q, k, v, window, causal, split=None):
        """``ops.attention``; with ``split`` (an ``ops.RowSplit``) only
        this rank's rows of each query chunk (``ops.rows_attention``)."""
        cfg = self.cfg
        kw = dict(causal=causal, window=window,
                  softcap=cfg.attn_logit_softcap, q_chunk=cfg.attn_chunk,
                  kv_chunk=2 * cfg.attn_chunk)
        if split is not None:
            return ops.rows_attention(q, k, v, split, **kw)
        return ops.attention(q, k, v, **kw)

    def _out(self, o, dtype):
        B, S, H, Dh = o.shape
        return o.to(dtype).reshape(B, S, H * Dh) @ self.wo.to(
            dtype).reshape(H * Dh, -1)

    def _on_mesh(self, x, positions, window, cache, mode, causal, dtype):
        """Train and prefill on a mesh, in a ``local_map`` region (PERF.md
        §3): x with its batch over the data axes and whole on ``model``,
        the heads split over ``model`` when it divides the query and the
        kv heads (Megatron's attention; else every model rank runs all
        heads), the output a partial sum over the split. k and v leave
        the region for the prefill's cache write. Where the rules hold
        ``attn_qchunk``, the heads stay whole and each rank attends and
        projects its rows of each query chunk (``ops.row_region``)."""
        mesh = mesh_of(x, self.wq)
        sx = sanitize_spec(Spec(rule("act_btd", mesh)[0], None, None),
                           x.shape, mesh)

        def region(split, hs, out_pl):
            skv = Spec(sx[0], None, hs, None)
            sw = Spec(None, hs, None)

            def local(xl, wq, wk, wv, wo, p):
                with local_params(self, wq=wq, wk=wk, wv=wv, wo=wo):
                    q, k, v = self._qkv(xl, p, dtype)
                    return self._out(self._attend(q, k, v, window, causal,
                                                  split), dtype), k, v
            return local_region(
                local, mesh,
                (x, self.wq, self.wk, self.wv, self.wo, positions),
                (sx, sw, sw, sw, Spec(hs, None, None), Spec(None, None)),
                (out_pl, placements(skv, mesh), placements(skv, mesh)))
        res = ops.row_region(mesh, sx[0], x.shape, self.cfg.attn_chunk,
                             lambda split, pl: region(split, None, pl))
        if res is None:
            hs = split_axis(mesh, self.wq.shape[1], self.wk.shape[1])
            res = region(None, hs, row_parallel(sx, mesh, hs))
        out, k, v = res
        if mode == "prefill":
            for n, t in (("k", k), ("v", v)):
                cache[n] = shard(prefill_cache(cache[n], t), "cache")
        return shard(out, "act_btd"), cache
