"""Model assembly: the ``dense``, ``vlm`` and ``audio`` families
(attention + gated MLP blocks; gemma2's local/global layer pairs with
post-norms; MLA attention for minicpm3; pixtral's patch frontend;
hubert's audio frontend and non-causal encoder), the ``moe`` family
(attention + top-k MoE blocks, with deepseek-v2's shared experts and
leading dense layers), the ``ssm`` family (RWKV-6 time-mix +
channel-mix blocks) and the ``hybrid`` family (zamba2: Mamba-2 blocks,
and one shared-weight attention block on concat(hidden, embed₀) after
every ``hybrid_attn_period`` of them).

``init_model(cfg, seed, device) → Transformer`` (an ``nn.Module`` with a
``ModuleList`` of blocks) and ``forward(model, batch, mode, caches, pos)
→ (logits, caches)``; ``forward(..., output="hidden")`` returns
((hidden, head), the summed MoE aux loss) for the fused training loss
instead. ``embed_inputs`` turns the batch ({"tokens"},
with "patches" for the vision stub; {"frames"}, with an optional
"mask", for the audio stub) into the first hidden state.

A model built for serving stores its matmul weights and the embedding in
the compute dtype ``cfg.dtype``, frozen: the JAX package keeps them in
``param_dtype`` and casts them at every use, which gives the same values.
A model built for training (``init_model(..., train=True)``) stores them
in ``param_dtype`` (f32 masters, which AdamW updates, as in JAX) and
casts at use; its weights require grad. Norm scales, and the RWKV and
Mamba-2 weights the JAX layers compute with in f32, stay f32 for serving;
for training every leaf is in ``param_dtype``, as in JAX (bf16 for
mixtral's and deepseek-v2's, norm scales included).
In ``mode="train"`` with ``cfg.remat`` each block is rematerialised
under autograd (``kernels.remat``), as JAX's scan body is.
``qk_norm``, which no config sets, raises ``NotImplementedError`` until
a caller needs it.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from ..device import resolve_device
from ..kernels import remat
from ..sharding.logical import (Spec, gathered, local_region, mesh_of,
                                placements, row_parallel, rule,
                                sanitize_spec, shard, spec_of, split_axis)
from .config import ModelConfig
from .layers.attention import Attention
from .layers.common import dense_init, rms_norm, softcap, weight
from .layers.mamba2 import Mamba2, init_mamba_state
from .layers.mla import MLA
from .layers.mlp import MLP, MoE
from .layers.rwkv6 import ChannelMix, TimeMix, init_rwkv_state

# family -> the attention types the port serves it with
_FAMILIES = {"dense": ("gqa", "mla"), "moe": ("gqa", "mla"),
             "vlm": ("gqa",), "audio": ("gqa",), "ssm": ("none",),
             "hybrid": ("gqa",)}
_RWKV_STATE = ("shift_t", "shift_c", "wkv")
_MAMBA_STATE = ("conv", "ssm")


def _check_supported(cfg: ModelConfig):
    unsupported = {
        "family": cfg.family not in _FAMILIES,
        "local_global_period": cfg.local_global_period not in (0, 2) or (
            cfg.local_global_period and cfg.n_layers % 2),
        "attn_type": cfg.attn_type not in _FAMILIES.get(cfg.family, ()),
        "qk_norm": cfg.qk_norm,
        "frontend": cfg.frontend not in (None, "vision_stub", "audio_stub"),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: the port serves the dense, vlm and audio (GQA, "
            "MLA, gemma2's local/global pairs, the vision and audio "
            "stubs), moe, RWKV-6 ssm and zamba2 hybrid families; "
            f"unsupported: {', '.join(bad)} (qk_norm: no JAX config sets "
            "it; it waits for a caller)")
    if cfg.family == "hybrid" and (
            cfg.hybrid_attn_period <= 0
            or cfg.n_layers % cfg.hybrid_attn_period):
        raise ValueError(f"{cfg.name}: {cfg.n_layers} Mamba-2 layers do not "
                         f"form groups of {cfg.hybrid_attn_period}")


def _layer_window(cfg: ModelConfig, i: int):
    """gemma2's pairs: even layers local (the window), odd layers global
    (none); every other arch's layers all take ``cfg.window``."""
    if cfg.local_global_period and i % 2:
        return None
    return cfg.window


def _shared_attn_cfg(cfg: ModelConfig) -> ModelConfig:
    """The shared block's attention runs at width 2·D."""
    return cfg.replace(d_head=2 * cfg.d_model // cfg.n_heads)


def _f32_param(n, device):
    return weight(n, dtype=torch.float32, device=device)


class Block(nn.Module):
    """ln1 → attention (GQA or MLA) [→ ln1b] → residual, ln2 → MLP or MoE
    [→ ln2b] → residual; the post-norms ln1b/ln2b only with gemma2's
    local/global pairs. ``moe=False`` in the moe family is one of its
    leading dense layers (deepseek-v2's first), an MLP of width d_ff.
    An encoder's attention is not causal."""

    def __init__(self, cfg: ModelConfig, dtype, device, window=None,
                 moe=False):
        super().__init__()
        self.ln1 = _f32_param(cfg.d_model, device)
        self.ln2 = _f32_param(cfg.d_model, device)
        self.attn = (MLA if cfg.attn_type == "mla" else Attention)(
            cfg, dtype, device)
        if moe:
            self.moe = MoE(cfg, dtype, device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.d_model, dtype, device)
        self.is_moe = moe
        if cfg.local_global_period:
            self.ln1b = _f32_param(cfg.d_model, device)
            self.ln2b = _f32_param(cfg.d_model, device)
        self.cfg = cfg
        self.window = window

    def forward(self, x, *, positions, cache, pos, mode, dtype):
        cfg = self.cfg
        h = rms_norm(x, self.ln1, cfg.norm_eps, plus_one=True)
        kw = {} if cfg.attn_type == "mla" else {
            "window": self.window, "causal": not cfg.is_encoder}
        a, cache = self.attn(h, positions=positions, cache=cache, pos=pos,
                             mode=mode, dtype=dtype, **kw)
        if cfg.local_global_period:
            a = rms_norm(a, self.ln1b, cfg.norm_eps, plus_one=True)
        x = x + a
        h = rms_norm(x, self.ln2, cfg.norm_eps, plus_one=True)
        aux = None
        if self.is_moe:
            m, aux = self.moe(h, dtype)
        else:
            m = self.mlp(h, cfg.act, dtype)
        if cfg.local_global_period:
            m = rms_norm(m, self.ln2b, cfg.norm_eps, plus_one=True)
        return x + m, cache, aux


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
        mesh = mesh_of(xc, self.down)
        if mesh is None:
            return x + xc.to(dtype) @ self.down.to(dtype)
        # a row-parallel product (PERF.md §3): xc's width and down's rows
        # split over ``model``, the output a partial sum
        ws = split_axis(mesh, self.down.shape[0])
        sx = sanitize_spec(Spec(rule("act_btd", mesh)[0], None, ws),
                           xc.shape, mesh)
        return x + shard(local_region(
            lambda a, w: a.to(dtype) @ w.to(dtype), mesh, (xc, self.down),
            (sx, Spec(ws, None)),
            row_parallel(Spec(sx[0], None, None), mesh, ws)), "act_btd")


class Transformer(nn.Module):
    """Parameters are allocated uninitialised; ``init_model`` draws them,
    ``load_state_dict(convert.from_jax_params(...))`` copies them.
    ``train=True`` stores the weights in ``cfg.param_dtype`` instead of
    the compute dtype ``cfg.dtype``."""

    def __init__(self, cfg: ModelConfig, device, train: bool = False):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        wdt = getattr(torch, cfg.param_dtype) if train else self.dtype
        Vp, D = cfg.padded_vocab, cfg.d_model
        self.embed = weight(Vp, D, dtype=wdt, device=device)
        self.final_norm = _f32_param(D, device)
        if cfg.frontend == "vision_stub":
            self.patch_proj = weight(cfg.frontend_dim, D, dtype=wdt,
                                     device=device)
        if cfg.frontend == "audio_stub":
            self.frame_proj = weight(cfg.frontend_dim, D, dtype=wdt,
                                     device=device)
            self.mask_emb = weight(D, dtype=wdt, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = weight(D, Vp, dtype=wdt, device=device)
        if cfg.family in ("ssm", "hybrid"):
            block = {"ssm": RWKVBlock, "hybrid": MambaBlock}[cfg.family]
            blocks = (block(cfg, wdt, device)
                      for _ in range(cfg.n_layers))
        else:
            nd = cfg.first_dense_layers
            blocks = (Block(cfg, wdt, device, _layer_window(cfg, i),
                            moe=cfg.family == "moe" and i >= nd)
                      for i in range(cfg.n_layers))
        self.blocks = nn.ModuleList(blocks)
        if cfg.family == "hybrid":
            self.shared = SharedAttention(cfg, wdt, device)
        if train:   # JAX keeps every leaf in param_dtype
            for mod in self.modules():
                for k, p in mod._parameters.items():
                    if p.dtype != wdt:
                        mod._parameters[k] = weight(*p.shape, dtype=wdt,
                                                    device=device)

    def forward(self, batch, *, mode="train", caches=None, pos=None,
                output="logits"):
        """batch ({"tokens" (B, S)}, with "patches" (B, Np, frontend_dim)
        for the vision stub; {"frames" (B, S, frontend_dim)}, with an
        optional bool "mask" (B, S), for the audio stub) → (logits (B,
        S [+ Np], padded_vocab), caches); with ``output="hidden"``
        ((hidden (B, S [+ Np], D), head (D, padded_vocab)), aux), both in
        the compute dtype, aux the MoE blocks' summed aux loss (f32, 0
        without MoE), as JAX's ``forward(..., output="hidden")``. An
        encoder runs in ``mode="train"`` only: the JAX package's prefill
        of an encoder, which has no cache, fails in ``attn_apply``, and an
        encoder has no decode."""
        cfg = self.cfg
        if cfg.is_encoder and mode != "train":
            raise ValueError(
                f"{cfg.name} is an encoder: it runs through forward(mode="
                f"'train') only (no cache, no decode), not mode={mode!r}")
        if output not in ("logits", "hidden"):
            raise ValueError(f"output must be 'logits' or 'hidden', got "
                             f"{output!r}")
        with gathered(self, recurse=False):
            return self._forward(batch, mode, caches, pos, output)

    def _forward(self, batch, mode, caches, pos, output):
        cfg, dtype = self.cfg, self.dtype
        x, positions, _ = embed_inputs(self, batch, mode, pos)
        aux = torch.zeros((), device=x.device)
        if cfg.family == "ssm":
            x = self._rwkv_blocks(x, caches, mode)
        elif cfg.family == "hybrid":
            x = self._hybrid_blocks(x, positions, caches, mode, pos)
        else:
            x, aux = self._attention_blocks(x, positions, caches, mode, pos)
        x = rms_norm(x, self.final_norm, cfg.norm_eps, plus_one=True)
        head = self.embed.T if cfg.tie_embeddings else self.lm_head
        if output == "hidden":
            return (x.to(dtype), head.to(dtype)), aux
        logits = softcap(x.to(dtype) @ head.to(dtype),
                         cfg.final_logit_softcap)
        if cfg.padded_vocab != cfg.vocab_size:   # mask vocab padding
            pad = torch.arange(cfg.padded_vocab,
                               device=logits.device) >= cfg.vocab_size
            logits = logits.masked_fill(pad, -1e9)
        return shard(logits, "logits"), caches

    def _run(self, mode, fn, *args):
        """``fn(*args)``, one block (``fn.func``): rematerialised under
        autograd in ``mode="train"`` with ``cfg.remat``. On a mesh the
        block's parameters are gathered over the FSDP axes for the call
        (again in the recompute), as XLA gathers them per layer."""
        def call(*a):
            with gathered(fn.func):
                return fn(*a)
        if self.cfg.remat and mode == "train":
            return remat(call, *args)
        return call(*args)

    def _attention_blocks(self, x, positions, caches, mode, pos):
        """→ (x, the MoE blocks' summed aux loss)."""
        aux = torch.zeros((), device=x.device)
        for i, blk in enumerate(self.blocks):
            cache = _layer_cache(self.cfg, caches, i) if caches else None
            x, _, a = self._run(mode, functools.partial(
                blk, positions=positions, cache=cache, pos=pos, mode=mode,
                dtype=self.dtype), x)
            if a is not None:
                aux = aux + a
        return x, aux

    def _rwkv_blocks(self, x, caches, mode):
        """Each block reads its state from the stacked caches and its new
        state is copied back in place (the JAX scan returns new arrays)."""
        for i, blk in enumerate(self.blocks):
            state = None if caches is None else {
                n: caches["layers"][n][i] for n in _RWKV_STATE}
            x, new = self._run(mode, functools.partial(
                blk, state=state, mode=mode, dtype=self.dtype), x)
            if state is not None and new is not None:
                for n in _RWKV_STATE:
                    state[n].copy_(new[n])
        return x

    def _hybrid_blocks(self, x, positions, caches, mode, pos):
        """Groups of ``hybrid_attn_period`` Mamba-2 blocks, each group
        followed by the shared attention block with the group's own
        cache. States are written back in place, as for RWKV-6."""
        embed0 = x
        per = self.cfg.hybrid_attn_period
        for i, blk in enumerate(self.blocks):
            state = None if caches is None else {
                n: caches["mamba"][n][i] for n in _MAMBA_STATE}
            x, new = self._run(mode, functools.partial(
                blk, state=state, mode=mode, dtype=self.dtype), x)
            if state is not None and new is not None:
                for n in _MAMBA_STATE:
                    state[n].copy_(new[n])
            if (i + 1) % per == 0:
                g = i // per
                cache = None if caches is None else {
                    n: caches["shared"][n][g] for n in ("k", "v")}
                x = self._run(mode, functools.partial(
                    self.shared, positions=positions, cache=cache, pos=pos,
                    mode=mode, dtype=self.dtype), x, embed0)
        return x


def embed_inputs(model: Transformer, batch: dict, mode: str, pos=None):
    """The JAX package's ``embed_inputs``: the batch → (x (B, S, D) in
    the compute dtype, positions, loss_mask). The audio stub projects
    ``frames`` by ``frame_proj`` and puts ``mask_emb`` at the frames that
    ``mask`` marks (positions 0..S−1 whatever the mode, no loss mask);
    otherwise the tokens are embedded (×√D rounded to the dtype for
    gemma2), and the vision stub prepends ``patches`` projected by
    ``patch_proj``, with positions 0..Np+S−1 and a loss mask of False
    over the Np patches and True over the S tokens (None without
    patches). Decode's one position is ``pos``."""
    cfg, dtype = model.cfg, model.dtype
    if cfg.frontend == "audio_stub":
        x = _frontend(batch["frames"], model.frame_proj, dtype)
        if "mask" in batch:
            x = torch.where(batch["mask"][..., None],
                            model.mask_emb.to(dtype), x)
        return (shard(x, "act_btd"),
                torch.arange(x.shape[1], device=x.device)[None, :], None)
    tok = batch["tokens"]
    B, S = tok.shape
    x = _embed(model.embed, tok).to(dtype)
    if cfg.emb_scale_by_sqrt_dim:       # √D rounded to dtype, as in JAX
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype)
    loss_mask = None
    if cfg.frontend == "vision_stub" and "patches" in batch:
        pe = _frontend(batch["patches"], model.patch_proj, dtype)
        x = torch.cat([pe, x], dim=1)
        Np = pe.shape[1]
        loss_mask = torch.cat(
            [torch.zeros(B, Np, dtype=torch.bool, device=x.device),
             torch.ones(B, S, dtype=torch.bool, device=x.device)], dim=1)
        S = S + Np
    if mode == "decode":
        positions = torch.full((B, 1), pos, device=x.device)
    else:
        positions = torch.arange(S, device=x.device)[None, :]
    return shard(x, "act_btd"), positions, loss_mask


def _frontend(x, w, dtype):
    """A frontend's projection ``x @ w``. On a mesh in a ``local_map``
    region (PERF.md §3): x with its batch over the data axes, w's
    columns split over ``model``, the output split alike (DTensor's own
    strategy fails on the gradient's strided shards)."""
    mesh = mesh_of(x, w)
    if mesh is None:
        return x.to(dtype) @ w.to(dtype)
    cs = split_axis(mesh, w.shape[1])
    sx = sanitize_spec(Spec(rule("act_btd", mesh)[0], None, None), x.shape,
                       mesh)
    return local_region(lambda a, b: a.to(dtype) @ b.to(dtype), mesh,
                        (x, w), (sx, Spec(None, cs)),
                        placements(Spec(sx[0], None, cs), mesh))


def _embed(table, tok):
    """``table[tok]``. On a mesh (the table's vocab rows split over
    ``model``, gathered over the data axes) each rank looks up the tokens
    its rows hold and zeros elsewhere, in a ``local_map`` region (PERF.md
    §3); the result is a partial sum over ``model`` (vocab-parallel
    embedding, as XLA lowers JAX's gather)."""
    mesh = mesh_of(table, tok)
    if mesh is None:
        return table[tok]
    from torch.distributed.tensor import Partial

    st = spec_of(table)
    stok = sanitize_spec(rule("act_btd", mesh)[:2], tok.shape, mesh)
    rows = () if st[0] is None else (
        st[0] if isinstance(st[0], tuple) else (st[0],))
    names = list(mesh.mesh_dim_names)
    out_pl = [Partial() if n in rows else p for n, p in
              zip(names, placements(Spec(*stok, None), mesh))]

    def local(t, ids):
        coord = mesh.get_coordinate() or [0] * len(names)
        r = 0
        for a in rows:
            i = names.index(a)
            r = r * mesh.shape[i] + coord[i]
        v0 = r * t.shape[0]
        hit = (ids >= v0) & (ids < v0 + t.shape[0])
        x = t[torch.where(hit, ids - v0, 0)]
        return torch.where(hit[..., None], x, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))
    return local_region(local, mesh, (table, tok),
                        (Spec(st[0], None), stok), out_pl)


def _layer_cache(cfg: ModelConfig, caches: dict, i: int) -> dict:
    """Layer i's views of the stacked caches: gemma2's pairs index their
    local or global stack by i // 2; the moe family's leading dense
    layers take ``dense_layers`` and the rest ``layers`` from i − nd."""
    layers, nd = caches["layers"], cfg.first_dense_layers
    if i < nd:
        layers = caches["dense_layers"]
    else:
        i -= nd
    if cfg.local_global_period:
        layers, i = layers["global" if i % 2 else "local"], i // 2
    return {n: t[i] for n, t in layers.items()}


def init_model(cfg: ModelConfig, seed: int = 0, device=None,
               train: bool = False) -> Transformer:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``,
    with the JAX package's init: truncated-normal fan-in matrices (MLA's
    and the MoE's too), the embedding scaled by √D, zero norm scales
    (stored as offsets from 1), the frontends' projections at fan-in
    ``frontend_dim`` and ``mask_emb`` at D;
    for RWKV-6 also the mixes at 0.5, the base decay ``w0`` at -4 and
    ``ln_x`` at 1; for Mamba-2 ``dt_bias``, ``A_log`` and the conv bias at
    0 and ``D`` at 1. ``device=None`` means the card. ``train=True``
    builds the training form: weights in ``cfg.param_dtype``, requiring
    grad (the same draws, unrounded)."""
    device = resolve_device(device)
    model = Transformer(cfg, device, train=train)
    g = torch.Generator(device=device).manual_seed(seed)
    D = cfg.d_model

    def fill(param, fan_in, mult=1.0):
        param.copy_(dense_init(param.shape, fan_in, g, device=device)
                    * mult)

    with torch.no_grad():
        fill(model.embed, D, D ** 0.5)
        if not cfg.tie_embeddings:
            fill(model.lm_head, D)
        if cfg.frontend == "vision_stub":
            fill(model.patch_proj, cfg.frontend_dim)
        if cfg.frontend == "audio_stub":
            fill(model.frame_proj, cfg.frontend_dim)
            fill(model.mask_emb, D)
        model.final_norm.zero_()
        if cfg.family == "hybrid":
            _init_hybrid(model, cfg, fill)
        else:
            for blk in model.blocks:
                blk.ln1.zero_()
                blk.ln2.zero_()
                if cfg.family == "ssm":
                    _init_rwkv_block(blk, cfg, fill)
                else:
                    _init_block(blk, cfg, fill)
    return model.requires_grad_(train)


def _init_block(blk: Block, cfg: ModelConfig, fill):
    """An attention block with the JAX package's fan-ins (``init_attn``
    or ``init_mla``, ``init_mlp`` or ``init_moe``, its shared experts an
    ``init_mlp`` of width moe_d_ff · n_shared_experts)."""
    D, a = cfg.d_model, blk.attn
    if cfg.attn_type == "mla":
        r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
        if r_q:
            fill(a.wq_a, D)
            a.q_a_norm.zero_()
            fill(a.wq_b, r_q)
        else:
            fill(a.wq, D)
        fill(a.wkv_a, D)
        a.kv_a_norm.zero_()
        fill(a.wk_b, r_kv)
        fill(a.wv_b, r_kv)
        fill(a.wo, cfg.n_heads * cfg.v_head_dim)
    else:
        for w in (a.wq, a.wk, a.wv):
            fill(w, D)
        fill(a.wo, cfg.n_heads * cfg.d_head)
    if blk.is_moe:
        m, f = blk.moe, cfg.moe_d_ff
        fill(m.router, D)
        if cfg.n_shared_experts:
            fill(m.shared.w_gate, D)
            fill(m.shared.w_up, D)
            fill(m.shared.w_down, f * cfg.n_shared_experts)
    else:
        m, f = blk.mlp, cfg.d_ff
    fill(m.w_gate, D)
    fill(m.w_up, D)
    fill(m.w_down, f)
    if cfg.local_global_period:
        blk.ln1b.zero_()
        blk.ln2b.zero_()


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
    dense, vlm and moe {"layers": {"k", "v": (L, B, C, KV, Dh)}}, C
    capped at the window (with leading dense layers, ``first_dense_layers``
    nd of them, the moe family's are split as JAX's: {"dense_layers": (nd,
    ...), "layers": (L − nd, ...)}, for GQA and MLA alike); an encoder
    {}; gemma2's pairs {"layers": {"local": {"k", "v": (L/2, B,
    min(C, window), KV, Dh)}, "global": {... (L/2, B, C, KV, Dh)}}}; MLA
    {"layers": {"ckv": (L, B, C, kv_lora), "krope": (L, B, C, rope)}};
    ssm {"layers": {"shift_t", "shift_c": (L, B, D), "wkv": (L, B, H, K,
    K) f32}}, a
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

    if cfg.is_encoder:
        return {}

    def kv(n_layers, cap):
        shape = (n_layers, batch, cap, cfg.n_kv_heads, cfg.d_head)
        return {n: torch.zeros(shape, dtype=dtype, device=device)
                for n in ("k", "v")}

    def mla(n_layers):
        return {n: torch.zeros((n_layers, batch, capacity, w), dtype=dtype,
                               device=device)
                for n, w in (("ckv", cfg.kv_lora_rank),
                             ("krope", cfg.qk_rope_dim))}
    if cfg.local_global_period:
        half = cfg.n_layers // 2
        return {"layers": {"local": kv(half, min(capacity, cfg.window)),
                           "global": kv(half, capacity)}}
    if cfg.attn_type == "mla":
        stack = mla
    else:
        cap = capacity if cfg.window is None else min(capacity, cfg.window)
        stack = functools.partial(kv, cap=cap)
    nd = cfg.first_dense_layers
    out = {"layers": stack(cfg.n_layers - nd)}
    if nd:
        out["dense_layers"] = stack(nd)
    return out


def forward(model: Transformer, batch: dict, *, mode: str = "train",
            caches: dict | None = None, pos: int | None = None,
            output: str = "logits"):
    """Returns (logits, caches); caches are updated in place. With
    ``output="hidden"``: ((hidden, head), the summed MoE aux loss)."""
    return model(batch, mode=mode, caches=caches, pos=pos, output=output)
