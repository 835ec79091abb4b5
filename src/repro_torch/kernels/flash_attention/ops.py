"""Public attention op: the CUDA flash kernel for CUDA tensors, the plain
blockwise version for CPU tensors. There is no fallback: a kernel that
does not build or launch raises. ``attention_ref`` is the O(S²) oracle
for tests.

On CUDA tensors the kernel runs inside ``FlashAttention``, an
``autograd.Function``: its forward is the kernel, its backward recomputes
the plain blockwise version on the saved inputs and differentiates it
(the JAX package's training path differentiates the same blockwise
function, rematerialised per KV block). On CPU tensors autograd
differentiates the plain version directly.
"""
from __future__ import annotations

import torch

from ...sharding.logical import heads_specs, local_region, mesh_of, placements
from .. import kernel_scope, plain_backward
from . import kernel
from .blockwise import blockwise_attention
from .ref import attention_ref  # noqa: F401


class FlashAttention(torch.autograd.Function):
    """forward: ``kernel.flash_attention``; backward: autograd of
    ``blockwise_attention`` at the same options and chunks, recomputed on
    the saved q, k, v. k and v may share storage (MLA passes the latent
    as both): each gets its own gradient, and autograd sums them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, q_chunk,
                kv_chunk):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        scale=scale, q_chunk=q_chunk, kv_chunk=kv_chunk)
        return kernel.flash_attention(q, k, v, causal=causal, window=window,
                                      softcap=softcap, scale=scale)

    @staticmethod
    def backward(ctx, grad_out):
        def plain(q, k, v):
            return (blockwise_attention(q, k, v, **ctx.opts),)
        return plain_backward(plain, ctx, (grad_out,), 6)


def kernel_attention(q, k, v, *, causal=True, window=None, softcap=None,
                     scale=None, q_chunk: int = 512, kv_chunk: int = 1024):
    """The kernel's route, differentiable: forward by the CUDA kernel,
    backward by the plain version (``q_chunk``/``kv_chunk`` tile its
    recompute)."""
    return FlashAttention.apply(q, k, v, causal, window, softcap, scale,
                                q_chunk, kv_chunk)


def attention(q, k, v, *, causal=True, window=None, softcap=None,
              scale=None, q_chunk: int = 512, kv_chunk: int = 1024):
    """(B, Sq, H, Dk), (B, Skv, KV, Dk), (B, Skv, KV, Dv) → (B, Sq, H, Dv).
    ``q_chunk``/``kv_chunk`` tile the plain version only; the kernel
    picks its own tiles."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              q_chunk=q_chunk, kv_chunk=kv_chunk)
    mesh = mesh_of(q, k, v)
    if mesh is not None:
        specs = heads_specs(mesh, q, k, v)
        return local_region(lambda a, b, c: attention(a, b, c, **kw), mesh,
                            (q, k, v), specs, placements(specs[0], mesh))
    with kernel_scope("flash_attention"):
        if q.device.type == "cpu":
            return blockwise_attention(q, k, v, **kw)
        return kernel_attention(q, k, v, **kw)
