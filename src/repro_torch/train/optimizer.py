"""AdamW with decoupled weight decay and global-norm clipping, the port
of the JAX package's ``train/optimizer.py``: the same math, on trees of
tensors (nested dicts; the port's parameters are a flat dict of names).

Everything is computed on the parameters' device in f32, the moments in
``m_dtype``/``v_dtype``, and the step count, bias corrections, learning
rate and norms stay 0-d device tensors: an update issues its per-tensor
arithmetic as ``torch._foreach_*`` calls and never waits for the device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..sharding.logical import is_dtensor


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def tree_leaves(tree) -> list:
    """The tensors of a tree of dicts and lists; a dict's in the order of
    its sorted keys, as ``jax.tree.leaves``, so two trees with the same
    keys line up whatever their insertion order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` on every leaf, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` in the order of
    ``tree_leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    """lr(step) → f32 tensor on the step's device: linear warm-up, then a
    cosine from ``peak_lr`` to ``final_frac · peak_lr``."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)
    return lr


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-d tensor)."""
    leaves = [g.float() for g in tree_leaves(tree)]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(leaves)))


def clip_by_global_norm(tree, max_norm: float, norm_fn=None):
    """(the tree scaled by min(1, max_norm / norm), each leaf in its own
    dtype; norm). ``norm_fn`` (default ``global_norm``) computes the
    norm."""
    norm = (norm_fn or global_norm)(tree)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def adamw(lr: float | Callable = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          clip_norm: float | None = 1.0,
          m_dtype=torch.float32, v_dtype=torch.float32) -> Optimizer:
    """``m_dtype=torch.bfloat16`` halves first-moment memory. No decay on
    tensors of rank < 2 (norms, biases), as JAX's ``p.ndim >= 2``; bias
    correction from the post-increment ``count``, as in JAX.

    The rank the decay rule reads is the leaf's own unless ``update`` is
    given ``ranks`` {name: rank} for a flat dict of parameters: the
    training step passes the ranks of the JAX leaves
    (``models.convert.jax_ranks``), which are stacked over the layers, so
    every block's norm scales (rank 2 in JAX) decay and ``final_norm``
    does not, as in JAX."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        # zeros_like: on a mesh the moments take their parameter's layout
        return {"m": tree_map(lambda p: torch.zeros_like(
                    p, dtype=m_dtype, requires_grad=False), params),
                "v": tree_map(lambda p: torch.zeros_like(
                    p, dtype=v_dtype, requires_grad=False), params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=tree_leaves(params)[0].device)}

    def update(grads, state, params, ranks: dict | None = None):
        """(grads, opt state, params) trees of the same structure →
        (new params, new opt state, {"grad_norm", "lr"}). Nothing is
        updated in place. ``ranks``: see ``adamw``. On DTensors the
        update runs on each rank's local shards (``_local_update``)."""
        if is_dtensor(tree_leaves(params)[0]):
            return _local_update(update_tensors, grads, state, params,
                                 ranks)
        return update_tensors(grads, state, params, ranks)

    def update_tensors(grads, state, params, ranks, norm_fn=None):
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm, norm_fn)
        else:
            gnorm = (norm_fn or global_norm)(grads)
        count = state["count"] + 1
        b1c = 1.0 - b1 ** count.float()
        b2c = 1.0 - b2 ** count.float()
        step_lr = lr_fn(count)

        p, g, m, v = (tree_leaves(t) for t in (params, grads, state["m"],
                                                state["v"]))
        # g32, p32 may be the caller's tensors and are only read; every
        # in-place op below writes a list this update allocated.
        g32 = [x.float() for x in g]
        p32 = [x.float() for x in p]
        m32 = torch._foreach_mul([x.float() for x in m], b1)
        torch._foreach_add_(m32, torch._foreach_mul(g32, 1 - b1))
        v32 = torch._foreach_mul([x.float() for x in v], b2)
        gg = torch._foreach_mul(g32, 1 - b2)
        torch._foreach_mul_(gg, g32)
        torch._foreach_add_(v32, gg)
        del gg
        delta = torch._foreach_div(m32, b1c)              # m̂
        den = torch._foreach_div(v32, b2c)                # v̂
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        torch._foreach_div_(delta, den)
        del den
        if weight_decay:
            rank = ([ranks[n] for n in sorted(params)] if ranks is not None
                    else [x.dim() for x in p])
            decay = [i for i, r in enumerate(rank) if r >= 2]
            torch._foreach_add_([delta[i] for i in decay], torch._foreach_mul(
                [p32[i] for i in decay], weight_decay))
        torch._foreach_mul_(delta, step_lr)
        new_p = [a.to(x.dtype) for a, x in zip(
            torch._foreach_sub(p32, delta), p)]
        del delta
        new_state = {"m": tree_unflatten(params, [x.to(m_dtype) for x in m32]),
                     "v": tree_unflatten(params, [x.to(v_dtype) for x in v32]),
                     "count": count}
        return (tree_unflatten(params, new_p), new_state,
                {"grad_norm": gnorm, "lr": step_lr})

    return Optimizer(init=init, update=update)


def _local_update(update, grads, state, params, ranks):
    """AdamW on a mesh: every moment has its parameter's placements (ZeRO
    by construction) and each gradient is brought to them (a partial
    gradient is reduced here), so the update is elementwise on the local
    shards and runs as ``torch._foreach_*`` on plain tensors. The global
    norm adds each rank's local squares, each divided by the number of
    ranks that replicate that tensor, in one all-reduce over the world
    (the mesh spans it)."""
    import torch.distributed._functional_collectives as fc
    from torch.distributed.tensor import DTensor, Replicate

    p = tree_leaves(params)
    g = [x.redistribute(y.device_mesh, y.placements)
         for x, y in zip(tree_leaves(grads), p)]
    reps = []
    for y in p:
        n = 1
        for size, pl in zip(tuple(y.device_mesh.shape), y.placements):
            if isinstance(pl, Replicate):
                n *= size
        reps.append(float(n))

    def norm_fn(tree):
        sq = torch.stack([x.float().pow(2).sum() / r for x, r in
                          zip(tree_leaves(tree), reps)]).sum()
        return torch.sqrt(fc.all_reduce(sq, "sum", torch.distributed.group
                                        .WORLD))

    def local(tree):
        return tree_map(lambda x: x.to_local(), tree)
    new_p, new_state, metrics = update(
        tree_unflatten(params, [x.to_local() for x in g]),
        {**state, "m": local(state["m"]), "v": local(state["v"]),
         "count": (state["count"].to_local() if is_dtensor(state["count"])
                   else state["count"])},
        local(params), ranks, norm_fn)

    def wrap(tree):
        return tree_unflatten(params, [
            DTensor.from_local(x, y.device_mesh, y.placements,
                               run_check=False, shape=y.shape,
                               stride=y.stride())
            for x, y in zip(tree_leaves(tree), p)])
    new_state = {**new_state, "m": wrap(new_state["m"]),
                 "v": wrap(new_state["v"])}
    return wrap(new_p), new_state, metrics
