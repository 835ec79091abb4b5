"""Error-feedback int8 gradient compression for the data-parallel
all-reduce (the port of the JAX package's ``train/grad_compress.py``).

Each rank quantises its gradient (plus the residual it kept from the
last step) to int8 with a per-tensor scale, the ranks average the
dequantised values, and each keeps its quantisation residual to add to
the next step's gradient (error feedback keeps SGD convergence).

Which payload travels: JAX's ``compressed_psum_mean`` all-reduces the
*dequantised f32* values (``psum(deq)``), not the int8 payload its
docstring names, and so does ``compressed_all_reduce_mean`` here: the
values equal JAX's, and the wire carries f32 (no traffic saving yet).
"""
from __future__ import annotations

import torch


def quantize_int8(x):
    """(q int8, scale f32 0-d): scale = max(max|x|, 1e-12) / 127,
    q = clip(round(x / scale), −127, 127), round half to even as
    ``jnp.round``."""
    x32 = x.float()
    scale = torch.clamp_min(x32.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def compress_residual(g, err):
    """Apply error feedback, quantise. Returns (q, scale, new_err)."""
    g32 = g.float() + err
    q, scale = quantize_int8(g32)
    new_err = g32 - dequantize_int8(q, scale)
    return q, scale, new_err


def compressed_all_reduce_mean(x, err, group=None):
    """Error-feedback int8 all-reduce mean of ``x`` over the ranks of
    ``group`` (the default world when None) → (mean, new_err). The
    dequantised f32 values are summed, as JAX's ``psum(deq)``."""
    import torch.distributed as dist

    q, scale, new_err = compress_residual(x, err)
    deq = dequantize_int8(q, scale)
    dist.all_reduce(deq, group=group)
    return deq / dist.get_world_size(group), new_err


def make_compressed_allreduce(mesh, axes: tuple[str, ...]):
    """→ ``f(grads, err_tree) -> (mean_grads, new_err_tree)`` over the
    mesh dims ``axes`` of a ``DeviceMesh`` (JAX's ``shard_map`` over
    those axes): every leaf is a local (plain) tensor each rank holds in
    full, averaged over the ranks of the flattened ``axes`` group."""
    group = (mesh[axes].get_group() if len(axes) == 1 else
             mesh[axes]._flatten().get_group())

    def run(grads, err):
        out = {k: compressed_all_reduce_mean(g, err[k], group)
               for k, g in grads.items()}
        return ({k: v[0] for k, v in out.items()},
                {k: v[1] for k, v in out.items()})
    return run
