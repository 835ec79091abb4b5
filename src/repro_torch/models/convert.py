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

# path in the JAX block tree -> port name; stacked shape beside each
_BLOCK_LEAVES = {
    ("ln1",): "ln1",
    ("ln2",): "ln2",
    ("attn", "wq"): "attn.wq",        # (L, D, H, Dh)
    ("attn", "wk"): "attn.wk",        # (L, D, KV, Dh)
    ("attn", "wv"): "attn.wv",        # (L, D, KV, Dh)
    ("attn", "wo"): "attn.wo",        # (L, H, Dh, D)
    ("mlp", "w_gate"): "mlp.w_gate",  # (L, D, F)
    ("mlp", "w_up"): "mlp.w_up",      # (L, D, F)
    ("mlp", "w_down"): "mlp.w_down",  # (L, F, D)
}
_NORMS = {"ln1", "ln2", "final_norm"}


def from_jax_params(cfg: ModelConfig, params: dict) -> dict:
    """Unstack the layer axis and name each leaf as the port's
    ``Transformer`` does. Matmul weights and the embedding are cast once
    to ``cfg.dtype`` (the JAX package casts them at every use, which
    gives the same values); norm scales stay f32. Load the result with
    ``model.load_state_dict``."""
    dtype = getattr(torch, cfg.dtype)

    def tensor(name, a):
        t = torch.from_numpy(np.asarray(a, dtype=np.float32).copy())
        return t if name.split(".")[-1] in _NORMS else t.to(dtype)

    state = {"embed": tensor("embed", params["embed"]),
             "final_norm": tensor("final_norm", params["final_norm"])}
    if not cfg.tie_embeddings:
        state["lm_head"] = tensor("lm_head", params["lm_head"])
    blocks = params["blocks"]
    for path, name in _BLOCK_LEAVES.items():
        leaf = blocks
        for key in path:
            leaf = leaf[key]
        if leaf.shape[0] != cfg.n_layers:
            raise ValueError(f"blocks/{'/'.join(path)} has {leaf.shape[0]} "
                             f"layers, config says {cfg.n_layers}")
        for i in range(cfg.n_layers):
            state[f"blocks.{i}.{name}"] = tensor(name, leaf[i])
    return state
