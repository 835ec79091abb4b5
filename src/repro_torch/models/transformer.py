"""Model assembly: the ``dense`` family (attention + gated MLP blocks),
the ``ssm`` family (RWKV-6 time-mix + channel-mix blocks) and the
``hybrid`` family (zamba2: Mamba-2 blocks, and one shared-weight
attention block on concat(hidden, embed₀) after every
``hybrid_attn_period`` of them).

``init_model(cfg, seed, device) → Transformer`` (an ``nn.Module`` with a
``ModuleList`` of blocks) and ``forward(model, batch, mode, caches, pos)
→ (logits, caches)``. Matmul weights and the embedding are stored in the
compute dtype ``cfg.dtype``: the JAX package keeps them in
``param_dtype`` and casts them at every use, which gives the same values.
Norm scales, and the RWKV and Mamba-2 weights the JAX layers compute
with in f32, stay f32. Other families, and options no ported arch uses
yet, raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .config import ModelConfig
from .layers.attention import Attention
from .layers.common import dense_init, rms_norm, softcap, weight
from .layers.mamba2 import Mamba2, init_mamba_state
from .layers.mlp import MLP
from .layers.rwkv6 import ChannelMix, TimeMix, init_rwkv_state

# family -> the attention type the port serves it with
_FAMILIES = {"dense": "gqa", "ssm": "none", "hybrid": "gqa"}
_RWKV_STATE = ("shift_t", "shift_c", "wkv")
_MAMBA_STATE = ("conv", "ssm")


def _check_supported(cfg: ModelConfig):
    unsupported = {
        "family": cfg.family not in _FAMILIES,
        "local_global_period": bool(cfg.local_global_period),
        "attn_type": cfg.attn_type != _FAMILIES.get(cfg.family),
        "qk_norm": cfg.qk_norm,
        "is_encoder": cfg.is_encoder,
        "frontend": cfg.frontend is not None,
        "emb_scale_by_sqrt_dim": cfg.emb_scale_by_sqrt_dim,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: the port serves the dense GQA, the RWKV-6 ssm and "
            "the zamba2 hybrid families only so far; "
            f"unsupported: {', '.join(bad)} (ROADMAP.md, queue A)")
    if cfg.family == "hybrid" and (
            cfg.hybrid_attn_period <= 0
            or cfg.n_layers % cfg.hybrid_attn_period):
        raise ValueError(f"{cfg.name}: {cfg.n_layers} Mamba-2 layers do not "
                         f"form groups of {cfg.hybrid_attn_period}")


def _shared_attn_cfg(cfg: ModelConfig) -> ModelConfig:
    """The shared block's attention runs at width 2·D."""
    return cfg.replace(d_head=2 * cfg.d_model // cfg.n_heads)


def _f32_param(n, device):
    return weight(n, dtype=torch.float32, device=device)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = _f32_param(cfg.d_model, device)
        self.ln2 = _f32_param(cfg.d_model, device)
        self.attn = Attention(cfg, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.d_model, dtype, device)
        self.cfg = cfg

    def forward(self, x, *, positions, cache, pos, mode, dtype):
        cfg = self.cfg
        h = rms_norm(x, self.ln1, cfg.norm_eps, plus_one=True)
        a, cache = self.attn(h, positions=positions, window=cfg.window,
                             cache=cache, pos=pos, mode=mode, dtype=dtype)
        x = x + a
        h = rms_norm(x, self.ln2, cfg.norm_eps, plus_one=True)
        return x + self.mlp(h, cfg.act, dtype), cache


class RWKVBlock(nn.Module):
    """ln1 → time mix → residual, ln2 → channel mix → residual."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = _f32_param(cfg.d_model, device)
        self.ln2 = _f32_param(cfg.d_model, device)
        self.time = TimeMix(cfg, dtype, device)
        self.chan = ChannelMix(cfg, dtype, device)
        self.cfg = cfg

    def forward(self, x, *, state, mode, dtype):
        """Returns (x, new state {"shift_t", "shift_c", "wkv"} or None)."""
        cfg = self.cfg
        h = rms_norm(x, self.ln1, cfg.norm_eps, plus_one=True)
        t, new_t = self.time(h, state=state, mode=mode, dtype=dtype)
        x = x + t
        h = rms_norm(x, self.ln2, cfg.norm_eps, plus_one=True)
        c, new_c = self.chan(h, state=state, mode=mode, dtype=dtype)
        return x + c, (None if new_t is None else {**new_t, **new_c})


class MambaBlock(nn.Module):
    """ln → Mamba-2 → residual."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln = _f32_param(cfg.d_model, device)
        self.mamba = Mamba2(cfg, dtype, device)
        self.cfg = cfg

    def forward(self, x, *, state, mode, dtype):
        h = rms_norm(x, self.ln, self.cfg.norm_eps, plus_one=True)
        o, new = self.mamba(h, state=state, mode=mode, dtype=dtype)
        return x + o, new


class SharedAttention(nn.Module):
    """zamba2's shared block, one set of weights called once per group on
    xc = concat(x, embed₀) (width 2·D): ln1 → attention → residual, ln2 →
    gated MLP → residual, then ``down`` (2·D → D) is added to x."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        D2 = 2 * cfg.d_model
        self.ln1 = _f32_param(D2, device)
        self.attn = Attention(_shared_attn_cfg(cfg), dtype, device,
                              d_in=D2, d_out=D2)
        self.ln2 = _f32_param(D2, device)
        self.mlp = MLP(D2, cfg.d_ff, D2, dtype, device)
        self.down = weight(D2, cfg.d_model, dtype=dtype, device=device)
        self.cfg = cfg

    def forward(self, x, embed0, *, positions, cache, pos, mode, dtype):
        cfg = self.cfg
        xc = torch.cat([x, embed0], dim=-1)
        h = rms_norm(xc, self.ln1, cfg.norm_eps, plus_one=True)
        a, _ = self.attn(h, positions=positions, window=cfg.window,
                         cache=cache, pos=pos, mode=mode, dtype=dtype)
        xc = xc + a
        h = rms_norm(xc, self.ln2, cfg.norm_eps, plus_one=True)
        xc = xc + self.mlp(h, cfg.act, dtype)
        return x + xc.to(dtype) @ self.down.to(dtype)


class Transformer(nn.Module):
    """Parameters are allocated uninitialised; ``init_model`` draws them,
    ``load_state_dict(convert.from_jax_params(...))`` copies them."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        Vp, D = cfg.padded_vocab, cfg.d_model
        self.embed = weight(Vp, D, dtype=self.dtype, device=device)
        self.final_norm = _f32_param(D, device)
        if not cfg.tie_embeddings:
            self.lm_head = weight(D, Vp, dtype=self.dtype, device=device)
        block = {"ssm": RWKVBlock, "hybrid": MambaBlock}.get(cfg.family,
                                                             Block)
        self.blocks = nn.ModuleList(block(cfg, self.dtype, device)
                                    for _ in range(cfg.n_layers))
        if cfg.family == "hybrid":
            self.shared = SharedAttention(cfg, self.dtype, device)

    def forward(self, tokens, *, mode="train", caches=None, pos=None):
        """tokens (B, S) → (logits (B, S, padded_vocab), caches)."""
        cfg, dtype = self.cfg, self.dtype
        x = self.embed[tokens].to(dtype)
        if cfg.family == "ssm":
            x = self._rwkv_blocks(x, caches, mode)
        elif cfg.family == "hybrid":
            x = self._hybrid_blocks(x, caches, mode, pos)
        else:
            x = self._attention_blocks(x, caches, mode, pos)
        x = rms_norm(x, self.final_norm, cfg.norm_eps, plus_one=True)
        head = self.embed.T if cfg.tie_embeddings else self.lm_head
        logits = softcap(x.to(dtype) @ head.to(dtype),
                         cfg.final_logit_softcap)
        if cfg.padded_vocab != cfg.vocab_size:   # mask vocab padding
            pad = torch.arange(cfg.padded_vocab,
                               device=logits.device) >= cfg.vocab_size
            logits = logits.masked_fill(pad, -1e9)
        return logits, caches

    @staticmethod
    def _positions(x, mode, pos):
        B, S = x.shape[:2]
        if mode == "decode":
            return torch.full((B, 1), pos, device=x.device)
        return torch.arange(S, device=x.device)[None, :]

    def _attention_blocks(self, x, caches, mode, pos):
        positions = self._positions(x, mode, pos)
        for i, blk in enumerate(self.blocks):
            cache = None if caches is None else {
                "k": caches["layers"]["k"][i], "v": caches["layers"]["v"][i]}
            x, _ = blk(x, positions=positions, cache=cache, pos=pos,
                       mode=mode, dtype=self.dtype)
        return x

    def _rwkv_blocks(self, x, caches, mode):
        """Each block reads its state from the stacked caches and its new
        state is copied back in place (the JAX scan returns new arrays)."""
        for i, blk in enumerate(self.blocks):
            state = None if caches is None else {
                n: caches["layers"][n][i] for n in _RWKV_STATE}
            x, new = blk(x, state=state, mode=mode, dtype=self.dtype)
            if state is not None and new is not None:
                for n in _RWKV_STATE:
                    state[n].copy_(new[n])
        return x

    def _hybrid_blocks(self, x, caches, mode, pos):
        """Groups of ``hybrid_attn_period`` Mamba-2 blocks, each group
        followed by the shared attention block with the group's own
        cache. States are written back in place, as for RWKV-6."""
        positions = self._positions(x, mode, pos)
        embed0 = x
        per = self.cfg.hybrid_attn_period
        for i, blk in enumerate(self.blocks):
            state = None if caches is None else {
                n: caches["mamba"][n][i] for n in _MAMBA_STATE}
            x, new = blk(x, state=state, mode=mode, dtype=self.dtype)
            if state is not None and new is not None:
                for n in _MAMBA_STATE:
                    state[n].copy_(new[n])
            if (i + 1) % per == 0:
                g = i // per
                cache = None if caches is None else {
                    n: caches["shared"][n][g] for n in ("k", "v")}
                x = self.shared(x, embed0, positions=positions, cache=cache,
                                pos=pos, mode=mode, dtype=self.dtype)
        return x


def init_model(cfg: ModelConfig, seed: int = 0, device=None) -> Transformer:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``,
    with the JAX package's init: truncated-normal fan-in matrices, the
    embedding scaled by √D, zero norm scales (stored as offsets from 1);
    for RWKV-6 also the mixes at 0.5, the base decay ``w0`` at -4 and
    ``ln_x`` at 1; for Mamba-2 ``dt_bias``, ``A_log`` and the conv bias at
    0 and ``D`` at 1. ``device=None`` means the card."""
    device = resolve_device(device)
    model = Transformer(cfg, device)
    g = torch.Generator(device=device).manual_seed(seed)
    D = cfg.d_model

    def fill(param, fan_in, mult=1.0):
        param.copy_(dense_init(param.shape, fan_in, g, device=device)
                    * mult)

    with torch.no_grad():
        fill(model.embed, D, D ** 0.5)
        if not cfg.tie_embeddings:
            fill(model.lm_head, D)
        model.final_norm.zero_()
        if cfg.family == "hybrid":
            _init_hybrid(model, cfg, fill)
            return model
        for blk in model.blocks:
            blk.ln1.zero_()
            blk.ln2.zero_()
            if cfg.family == "ssm":
                _init_rwkv_block(blk, cfg, fill)
                continue
            for w in (blk.attn.wq, blk.attn.wk, blk.attn.wv):
                fill(w, D)
            fill(blk.attn.wo, cfg.n_heads * cfg.d_head)
            fill(blk.mlp.w_gate, D)
            fill(blk.mlp.w_up, D)
            fill(blk.mlp.w_down, cfg.d_ff)
    return model


def _init_hybrid(model: Transformer, cfg: ModelConfig, fill):
    D = cfg.d_model
    for blk in model.blocks:
        m = blk.mamba
        blk.ln.zero_()
        fill(m.in_proj, D)
        fill(m.conv_w, cfg.ssm_conv)
        for p in (m.conv_b, m.dt_bias, m.A_log, m.norm):
            p.zero_()
        m.D.fill_(1.0)
        fill(m.out_proj, cfg.d_inner)
    sh, D2 = model.shared, 2 * D
    sh.ln1.zero_()
    sh.ln2.zero_()
    for w in (sh.attn.wq, sh.attn.wk, sh.attn.wv, sh.mlp.w_gate,
              sh.mlp.w_up, sh.down):
        fill(w, D2)
    fill(sh.attn.wo, cfg.n_heads * _shared_attn_cfg(cfg).d_head)
    fill(sh.mlp.w_down, cfg.d_ff)


def _init_rwkv_block(blk: RWKVBlock, cfg: ModelConfig, fill):
    D, tm, cm = cfg.d_model, blk.time, blk.chan
    tm.mu_base.fill_(0.5)
    fill(tm.mix_A, D)
    fill(tm.mix_B, cfg.rwkv_mix_lora)
    for w in (tm.wr, tm.wk, tm.wv, tm.wg, tm.wo):
        fill(w, D)
    tm.w0.fill_(-4.0)                     # base decay w ≈ exp(-e^-4)
    fill(tm.decay_A, D)
    fill(tm.decay_B, cfg.rwkv_decay_lora)
    fill(tm.u, cfg.rwkv_head_dim)
    tm.ln_x.fill_(1.0)
    cm.cmix_mu.fill_(0.5)
    fill(cm.ck, D)
    fill(cm.cv, cfg.d_ff)
    fill(cm.cr, D)


def init_caches(cfg: ModelConfig, batch: int, capacity: int,
                dtype=torch.bfloat16, device=None) -> dict:
    """Serving state for the whole model, stacked along the layer axis:
    dense {"layers": {"k", "v": (L, B, C, KV, Dh)}}; ssm {"layers":
    {"shift_t", "shift_c": (L, B, D), "wkv": (L, B, H, K, K) f32}}, a
    constant size whatever ``capacity``; hybrid {"mamba": {"conv": (L, B,
    K−1, conv channels), "ssm": (L, B, H, P, N) f32}, "shared": {"k", "v":
    (groups, B, min(capacity, window), KV, 2·D / n_heads)}}. The cache
    (the token shifts for ssm, the conv rows for hybrid) is bf16 by
    default even when ``cfg.dtype`` is f32, as in the JAX package.
    ``device=None`` means the card."""
    _check_supported(cfg)
    device = resolve_device(device)
    if cfg.family == "hybrid":
        one = init_mamba_state(cfg, batch, dtype, device)
        sub = _shared_attn_cfg(cfg)
        cap = min(capacity, cfg.window or capacity)
        shape = (cfg.n_layers // cfg.hybrid_attn_period, batch, cap,
                 sub.n_kv_heads, sub.d_head)
        return {"mamba": {n: t.new_zeros((cfg.n_layers, *t.shape))
                          for n, t in one.items()},
                "shared": {n: torch.zeros(shape, dtype=dtype, device=device)
                           for n in ("k", "v")}}
    if cfg.family == "ssm":
        one = init_rwkv_state(cfg, batch, dtype, device)
        return {"layers": {n: t.new_zeros((cfg.n_layers, *t.shape))
                           for n, t in one.items()}}
    cap = capacity if cfg.window is None else min(capacity, cfg.window)
    shape = (cfg.n_layers, batch, cap, cfg.n_kv_heads, cfg.d_head)
    return {"layers": {n: torch.zeros(shape, dtype=dtype, device=device)
                       for n in ("k", "v")}}


def forward(model: Transformer, batch: dict, *, mode: str = "train",
            caches: dict | None = None, pos: int | None = None):
    """Returns (logits, caches); caches are updated in place."""
    return model(batch["tokens"], mode=mode, caches=caches, pos=pos)
