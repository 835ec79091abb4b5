"""Train step factory (the port of the JAX package's
``train/train_step.py``): loss per family, gradients, microbatch
accumulation, optimizer update.

``TrainState`` is a plain dict tree, {"params", "opt", "step"}: params a
flat dict of the port's parameter names (``Transformer``'s state dict),
opt {"m", "v", "count"}, step a 0-d int32 tensor. A step is pure: it
returns a new state and leaves the one it was given as it was, so a
caller may reject the step (``runtime.FaultTolerantLoop``).

Each loss builds the model's module tree as a skeleton on the meta device
(``skeleton``, milliseconds) and ``bind``s its parameters to the state's
tensors for the loss and its backward (the per-block remat recomputes
through the same tensors).
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.convert import jax_ranks
from ..models.loss import fused_lm_loss
from ..models.transformer import Transformer, forward
from ..sharding.logical import (Spec, gather_dim, mesh_of, placements,
                                sanitize_spec)
from ..sharding.partition_specs import batch_axes, data_specs
from .optimizer import Optimizer, tree_map

TrainState = dict  # {"params": {name: tensor}, "opt": {...}, "step": i32}


def init_train_state(params: dict, optimizer: Optimizer) -> TrainState:
    """params: {name: tensor}, e.g. ``dict(init_model(cfg, seed, device,
    train=True).named_parameters())``."""
    device = next(iter(params.values())).device
    return {"params": dict(params), "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def skeleton(cfg) -> Transformer:
    """The model's module tree with parameters on the meta device (no
    memory), for ``bind``."""
    return Transformer(cfg, "meta", train=True)


def bind(model: Transformer, params: dict) -> Transformer:
    """Point every parameter of ``model`` at ``params[name]`` (no copy).
    The names must be exactly the model's."""
    names = {n for n, _ in model.named_parameters()}
    if names != set(params):
        raise KeyError(f"parameters missing {sorted(names - set(params))}, "
                       f"unknown {sorted(set(params) - names)}")
    for name, p in params.items():
        mod, _, leaf = name.rpartition(".")
        model.get_submodule(mod)._parameters[leaf] = p
    return model


def to_device(batch: dict, device) -> dict:
    """A numpy batch on ``device``: integer arrays as int64 (token and
    label indices), the rest as they are."""
    def put(a):
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.asarray(a))
        if not t.is_floating_point() and t.dtype != torch.bool:
            t = t.long()
        return t.to(device, non_blocking=True)
    return {k: put(v) for k, v in batch.items()}


def loss_for(cfg, params, batch, aux_weight: float = 0.01):
    """Training loss via the fused (chunked) CE path: (B, S, vocab)
    logits are never materialised. ``params`` {name: tensor}, ``batch``
    tensors on their device. → (loss + aux_weight · aux, {"loss",
    "aux"})."""
    model = bind(skeleton(cfg), params)
    (hidden, head), aux = forward(model, batch, mode="train",
                                  output="hidden")
    kw = dict(final_softcap=cfg.final_logit_softcap,
              vocab_size=cfg.vocab_size, chunk=cfg.loss_chunk)
    if cfg.is_encoder:
        loss = fused_lm_loss(hidden, head, batch["labels"],
                             mask=batch["mask"], shift=False, **kw)
    elif cfg.frontend == "vision_stub":
        loss = fused_lm_loss(hidden[:, cfg.frontend_tokens:], head,
                             batch["tokens"], **kw)
    else:
        loss = fused_lm_loss(hidden, head, batch["tokens"], **kw)
    return loss + aux_weight * aux, {"loss": loss, "aux": aux}


def grads_of(cfg, params, batch):
    """(gradients {name: tensor} in each parameter's dtype, metrics
    {"loss", "aux"} detached) of ``loss_for`` at ``params``."""
    leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
    tot, metrics = loss_for(cfg, leaves, batch)
    # a parameter off the loss's path (an encoder's token embedding) gets
    # zeros, as under jax.grad
    grads = torch.autograd.grad(tot, list(leaves.values()),
                                allow_unused=True, materialize_grads=True)
    return (dict(zip(leaves, grads)),
            {k: v.detach() for k, v in metrics.items()})


def microbatches(batch: dict, n: int) -> list[dict]:
    """The n microbatches of ``batch``: microbatch i is rows i·b..(i+1)·b
    − 1 of each input, b = rows // n, the tail dropped (JAX's
    ``x[:b·n].reshape(n, b, …)``). On a mesh each input is gathered along
    its rows once, and each microbatch is laid out as ``data_specs`` says
    for its key (the data axes on its first dim for any other), sanitised
    against its shape, which moves no data: the microbatches are the
    one-device ones on every mesh."""
    out = [{} for _ in range(n)]
    for key, v in batch.items():
        v = gather_dim(v, 0)
        mesh, b = mesh_of(v), v.shape[0] // n
        for i, micro in enumerate(out):
            rows = v[i * b:(i + 1) * b]
            if mesh is not None:
                spec = data_specs(mesh).get(key) or Spec(batch_axes(mesh))
                rows = rows.redistribute(mesh, placements(
                    sanitize_spec(spec, rows.shape, mesh), mesh))
            micro[key] = rows
    return out


def accumulated_grads(cfg, params, batch, accum_steps: int = 1,
                      accum_dtype=torch.float32):
    """``grads_of`` the batch, or with ``accum_steps > 1`` the mean of
    ``grads_of`` its microbatches (``microbatches``), run one after
    another and summed in ``accum_dtype``: (gradients, metrics {"loss",
    "aux"})."""
    if accum_steps == 1:
        return grads_of(cfg, params, batch)
    grads = {n: torch.zeros_like(p, dtype=accum_dtype)
             for n, p in params.items()}
    metrics = {k: torch.zeros((), device=next(iter(params.values())).device)
               for k in ("loss", "aux")}
    for micro in microbatches(batch, accum_steps):
        g, m = grads_of(cfg, params, micro)
        torch._foreach_add_(list(grads.values()), [
            g[n].to(accum_dtype) for n in grads])
        metrics = {k: metrics[k] + m[k] for k in metrics}
    return (tree_map(lambda g: g / accum_steps, grads),
            tree_map(lambda m: m / accum_steps, metrics))


def make_train_step(cfg, optimizer: Optimizer, accum_steps: int = 1,
                    accum_dtype=torch.float32):
    """Returns ``train_step(state, batch) -> (state, metrics)``; the batch
    is numpy (the pipeline's) or tensors, and goes to the parameters'
    device here.

    ``accum_steps > 1`` splits the batch into microbatches run one after
    another, their gradients summed in ``accum_dtype`` and averaged:
    activation memory of one microbatch. Metrics stay 0-d device
    tensors: reading them is the caller's one host sync. Weight decay
    reads the JAX leaves' ranks (``models.convert.jax_ranks``).
    """
    def train_step(state: TrainState, batch: dict):
        params = state["params"]
        device = next(iter(params.values())).device
        batch = to_device(batch, device)
        grads, metrics = accumulated_grads(cfg, params, batch, accum_steps,
                                           accum_dtype)
        with torch.no_grad():
            new_params, new_opt, opt_metrics = optimizer.update(
                grads, state["opt"], params, ranks=jax_ranks(cfg, params))
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {**metrics, **opt_metrics}

    return train_step
