"""Convert the JAX package's parameter tree into the port's state dict,
so both frameworks can run the very same weights.

``params`` is the tree ``init_model`` returns in the JAX package, with
every leaf already converted to a numpy array (the port imports no JAX):
``{"embed": (Vp, D), "final_norm": (D,), ["lm_head": (D, Vp)],
"blocks": {...}}`` with the blocks stacked on a leading layer axis.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig

# path in the JAX block tree -> port name, per family; stacked shape beside
# each
_BLOCK_LEAVES = {
    "dense": {
        ("ln1",): "ln1",
        ("ln2",): "ln2",
        ("attn", "wq"): "attn.wq",        # (L, D, H, Dh)
        ("attn", "wk"): "attn.wk",        # (L, D, KV, Dh)
        ("attn", "wv"): "attn.wv",        # (L, D, KV, Dh)
        ("attn", "wo"): "attn.wo",        # (L, H, Dh, D)
        ("mlp", "w_gate"): "mlp.w_gate",  # (L, D, F)
        ("mlp", "w_up"): "mlp.w_up",      # (L, D, F)
        ("mlp", "w_down"): "mlp.w_down",  # (L, F, D)
    },
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
}
# Kept in f32: the norm scales, and the RWKV-6 weights the JAX layer
# computes with in f32 (decay LoRA, bonus u inside the WKV, ln_x scale).
_F32 = {"ln1", "ln2", "final_norm", "time.w0", "time.decay_A",
        "time.decay_B", "time.u", "time.ln_x"}


def from_jax_params(cfg: ModelConfig, params: dict) -> dict:
    """Unstack the layer axis and name each leaf as the port's
    ``Transformer`` does. Matmul weights, mixes and the embedding are
    cast once to ``cfg.dtype`` (the JAX package casts them at every use,
    which gives the same values); the leaves in ``_F32`` stay f32. Load
    the result with ``model.load_state_dict``."""
    dtype = getattr(torch, cfg.dtype)

    def tensor(name, a):
        t = torch.from_numpy(np.asarray(a, dtype=np.float32).copy())
        return t if name in _F32 else t.to(dtype)

    state = {"embed": tensor("embed", params["embed"]),
             "final_norm": tensor("final_norm", params["final_norm"])}
    if not cfg.tie_embeddings:
        state["lm_head"] = tensor("lm_head", params["lm_head"])
    blocks = params["blocks"]
    for path, name in _BLOCK_LEAVES[cfg.family].items():
        leaf = blocks
        for key in path:
            leaf = leaf[key]
        if leaf.shape[0] != cfg.n_layers:
            raise ValueError(f"blocks/{'/'.join(path)} has {leaf.shape[0]} "
                             f"layers, config says {cfg.n_layers}")
        for i in range(cfg.n_layers):
            state[f"blocks.{i}.{name}"] = tensor(name, leaf[i])
    return state
