"""Convert the JAX package's parameter tree into the port's state dict,
so both frameworks can run the very same weights.

``params`` is the tree ``init_model`` returns in the JAX package, with
every leaf already converted to a numpy array (the port imports no JAX):
``{"embed": (Vp, D), "final_norm": (D,), ["lm_head": (D, Vp)],
"blocks": {...}}`` with the blocks stacked on a leading layer axis —
for gemma2's pairs as two trees ``{"local", "global"}`` of L/2 layers
each (interleaved back into layer order here), for the hybrid family on
two axes, (groups, period), and beside them the unstacked
``shared_attn`` tree of the one shared attention block; for the moe
family's leading dense layers a ``dense_blocks`` tree of
``first_dense_layers`` layers (layers 0..nd−1 here, ``blocks`` the rest);
the frontends' ``patch_proj`` (frontend_dim, D), ``frame_proj``
(frontend_dim, D) and ``mask_emb`` (D,) at the top. bf16 leaves (a
``param_dtype`` of bfloat16, as mixtral's and deepseek-v2's) arrive as
numpy's bfloat16 extension type and are read through f32.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig

# path in the JAX block tree -> port name, per family; stacked shape beside
# each. The dense and moe families take their attention and MLP leaves
# from the config (``_block_leaves``).
_ATTN = {
    ("attn", "wq"): "attn.wq",            # (L, D, H, Dh)
    ("attn", "wk"): "attn.wk",            # (L, D, KV, Dh)
    ("attn", "wv"): "attn.wv",            # (L, D, KV, Dh)
    ("attn", "wo"): "attn.wo",            # (L, H, Dh, D)
}
# MLA's leaves, beside each its stacked shape: q through the low-rank
# pair when q_lora_rank is set, else through one full-rank wq.
_MLA_Q = {True: ("wq_a",                  # (L, D, q_lora)
                 "q_a_norm",              # (L, q_lora)
                 "wq_b"),                 # (L, q_lora, H, nope + rope)
          False: ("wq",)}                 # (L, D, H, nope + rope)
_MLA_KV = ("wkv_a",                       # (L, D, kv_lora + rope)
           "kv_a_norm",                   # (L, kv_lora)
           "wk_b",                        # (L, kv_lora, H, nope)
           "wv_b",                        # (L, kv_lora, H, v_head)
           "wo")                          # (L, H, v_head, D)
_MLP = {("mlp", n): f"mlp.{n}" for n in (
    "w_gate", "w_up",                     # (L, D, F)
    "w_down")}                            # (L, F, D)
_MOE = {("moe", n): f"moe.{n}" for n in (
    "router",                             # (L, D, E)
    "w_gate", "w_up",                     # (L, E, D, F)
    "w_down")}                            # (L, E, F, D)
_SHARED_EXPERTS = {("moe", "shared", n): f"moe.shared.{n}" for n in (
    "w_gate", "w_up",                     # (L, D, F · n_shared)
    "w_down")}                            # (L, F · n_shared, D)
# Top-level leaves of the frontends, (frontend_dim, D) and (D,).
_FRONTEND = {"vision_stub": ("patch_proj",),
             "audio_stub": ("frame_proj", "mask_emb")}
_POST_NORMS = {("ln1b",): "ln1b", ("ln2b",): "ln2b"}   # gemma2, (L, D)
_BLOCK_LEAVES = {
    "ssm": {
        ("ln1",): "ln1",
        ("ln2",): "ln2",
        **{("time", n): f"time.{n}" for n in (
            "mu_base",                    # (L, 5, D)
            "mix_A",                      # (L, D, 5 * mix_lora)
            "mix_B",                      # (L, 5, mix_lora, D)
            "wr", "wk", "wv", "wg", "wo",  # (L, D, D)
            "w0",                         # (L, D)
            "decay_A",                    # (L, D, decay_lora)
            "decay_B",                    # (L, decay_lora, D)
            "u",                          # (L, H, K)
            "ln_x")},                     # (L, D)
        **{("time", n): f"chan.{n}" for n in (
            "cmix_mu",                    # (L, 2, D)
            "ck",                         # (L, D, F)
            "cv",                         # (L, F, D)
            "cr")},                       # (L, D, D)
    },
    "hybrid": {                           # stacked (groups, period, ...)
        ("ln",): "ln",
        **{("mamba", n): f"mamba.{n}" for n in (
            "in_proj",                    # (D, 2·di + 2·N + H)
            "conv_w",                     # (K, di + 2·N)
            "conv_b",                     # (di + 2·N,)
            "dt_bias", "A_log", "D",      # (H,)
            "norm",                       # (di,)
            "out_proj")},                 # (di, D)
    },
}
# The hybrid family's shared attention block: path in ``shared_attn`` ->
# port name (unstacked).
_SHARED_LEAVES = {
    ("ln1",): "shared.ln1",               # (2D,)
    ("ln2",): "shared.ln2",
    **{("attn", n): f"shared.attn.{n}" for n in ("wq", "wk", "wv", "wo")},
    **{("mlp", n): f"shared.mlp.{n}" for n in ("w_gate", "w_up",
                                               "w_down")},
    ("down",): "shared.down",             # (2D, D)
}


def _block_leaves(cfg: ModelConfig, moe: bool) -> dict:
    """The leaves of one block: an MoE block's (``moe``) or an MLP
    block's, for the attention families."""
    if cfg.family in _BLOCK_LEAVES:
        return _BLOCK_LEAVES[cfg.family]
    if cfg.attn_type == "mla":
        attn = {("attn", n): f"attn.{n}"
                for n in _MLA_Q[bool(cfg.q_lora_rank)] + _MLA_KV}
    else:
        attn = _ATTN
    mix = _MLP
    if moe:
        mix = {**_MOE, **(_SHARED_EXPERTS if cfg.n_shared_experts else {})}
    return {("ln1",): "ln1", ("ln2",): "ln2", **attn, **mix,
            **(_POST_NORMS if cfg.local_global_period else {})}


# Kept in f32: the norm scales, and the RWKV-6 and Mamba-2 weights the
# JAX layers compute with in f32 (decay LoRA, bonus u inside the WKV,
# ln_x scale; dt_bias, A_log, D and the gated norm's scale).
_F32 = {"ln", "ln1", "ln2", "ln1b", "ln2b", "attn.q_a_norm",
        "attn.kv_a_norm", "final_norm", "time.w0", "time.decay_A",
        "time.decay_B", "time.u", "time.ln_x", "mamba.dt_bias",
        "mamba.A_log", "mamba.D", "mamba.norm", "shared.ln1", "shared.ln2"}


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def from_jax_params(cfg: ModelConfig, params: dict, dtype=None) -> dict:
    """Unstack the layer axis and name each leaf as the port's
    ``Transformer`` does. Matmul weights, mixes and the embedding are
    cast once to ``cfg.dtype`` (the JAX package casts them at every use,
    which gives the same values); the leaves in ``_F32`` stay f32. Load
    the result with ``model.load_state_dict``. ``dtype`` given: every
    leaf in it instead (a training model's masters, Adam's moments)."""
    compute = getattr(torch, cfg.dtype)

    def tensor(name, a):
        t = torch.from_numpy(np.asarray(a, dtype=np.float32).copy())
        if dtype is not None:
            return t.to(dtype)
        return t if name in _F32 else t.to(compute)

    state = {"embed": tensor("embed", params["embed"]),
             "final_norm": tensor("final_norm", params["final_norm"])}
    if not cfg.tie_embeddings:
        state["lm_head"] = tensor("lm_head", params["lm_head"])
    for name in _FRONTEND.get(cfg.frontend, ()):
        state[name] = tensor(name, params[name])
    hybrid = cfg.family == "hybrid"
    nd = cfg.first_dense_layers
    # (tree, its first layer, its layer count, MoE blocks or not)
    stacks = [("blocks", nd, cfg.n_layers - nd, cfg.family == "moe")]
    if nd:
        stacks.insert(0, ("dense_blocks", 0, nd, False))
    for tree, first, n_layers, moe in stacks:
        for path, name in _block_leaves(cfg, moe).items():
            where = f"{tree}/{'/'.join(path)}"
            if cfg.local_global_period:   # (L/2, ...) local, global stacks
                pair = [np.asarray(_leaf(params[tree][k], path))
                        for k in ("local", "global")]
                leaf = np.stack(pair, axis=1).reshape(-1, *pair[0].shape[1:])
            else:
                leaf = np.asarray(_leaf(params[tree], path))
            if hybrid:   # (groups, period, ...) -> (layers, ...)
                if leaf.shape[1] != cfg.hybrid_attn_period:
                    raise ValueError(f"{where} has groups of {leaf.shape[1]} "
                                     "layers, config says "
                                     f"{cfg.hybrid_attn_period}")
                leaf = leaf.reshape(-1, *leaf.shape[2:])
            if leaf.shape[0] != n_layers:
                raise ValueError(f"{where} has {leaf.shape[0]} layers, "
                                 f"config says {n_layers}")
            for i in range(n_layers):
                state[f"blocks.{first + i}.{name}"] = tensor(name, leaf[i])
    if hybrid:
        for path, name in _SHARED_LEAVES.items():
            state[name] = tensor(name, _leaf(params["shared_attn"], path))
    return state


def jax_leaf_paths(cfg: ModelConfig) -> dict:
    """{port name: (path of its leaf in the JAX parameter tree, the number
    of stack dims that leaf has before the port's shape)}: 0 for the
    top-level leaves and ``shared_attn``, 1 in a stacked block (gemma2's
    pairs under their ``local``/``global`` stack), 2 in the hybrid
    family's (groups, period) stack. The same tables as
    ``from_jax_params``."""
    out = {"embed": (("embed",), 0), "final_norm": (("final_norm",), 0)}
    if not cfg.tie_embeddings:
        out["lm_head"] = (("lm_head",), 0)
    for name in _FRONTEND.get(cfg.frontend, ()):
        out[name] = ((name,), 0)
    nd = cfg.first_dense_layers
    stack = 2 if cfg.family == "hybrid" else 1
    for i in range(cfg.n_layers):
        tree = ("dense_blocks",) if i < nd else ("blocks",)
        if cfg.local_global_period:
            tree += ("global" if (i - nd) % 2 else "local",)
        moe = cfg.family == "moe" and i >= nd
        for path, name in _block_leaves(cfg, moe).items():
            out[f"blocks.{i}.{name}"] = (tree + path, stack)
    if cfg.family == "hybrid":
        for path, name in _SHARED_LEAVES.items():
            out[name] = (("shared_attn",) + path, 0)
    return out


def jax_ranks(cfg: ModelConfig, params: dict) -> dict:
    """{port name: the rank of its JAX leaf}: the port's rank plus the
    leaf's stack dims (``jax_leaf_paths``). ``params`` {name: tensor}."""
    paths = jax_leaf_paths(cfg)
    return {n: p.dim() + paths[n][1] for n, p in params.items()}


def train_state_from_jax(cfg: ModelConfig, state: dict) -> dict:
    """A JAX ``TrainState`` with numpy leaves ({"params", "opt": {"m",
    "v", "count"}, "step"}) → the port's (``train.train_step``): params
    through ``from_jax_params`` kept in ``cfg.param_dtype``; m and v,
    which have the params' tree, through the same mapping in f32;
    ``count`` and ``step`` as they are (0-d int32), all on the CPU."""
    def counter(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int32).copy())
    opt = state["opt"]
    return {"params": from_jax_params(cfg, state["params"],
                                      getattr(torch, cfg.param_dtype)),
            "opt": {"m": from_jax_params(cfg, opt["m"], torch.float32),
                    "v": from_jax_params(cfg, opt["v"], torch.float32),
                    "count": counter(opt["count"])},
            "step": counter(state["step"])}
