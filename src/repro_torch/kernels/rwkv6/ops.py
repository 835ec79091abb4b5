"""Public WKV-6 op: the CUDA kernel for CUDA tensors, the plain chunked
version for CPU tensors. There is no fallback: a kernel that does not
build or launch raises. ``wkv6_ref`` is the sequential oracle for
tests.

On CUDA tensors the kernel runs inside ``WKV6``, an
``autograd.Function``: its forward is the kernel, its backward recomputes
the plain chunked version on the saved inputs and differentiates it (the
JAX package's training path differentiates the same chunked function,
rematerialised per chunk). On CPU tensors autograd differentiates the
plain version directly. On DTensors the op runs on each rank's local
shard through ``local_map`` (the batch over the data axes, the heads over
``model``), as ``flash_attention.ops.attention`` does.
"""
from __future__ import annotations

import torch

from ...sharding.logical import (Spec, heads_specs, local_region, mesh_of,
                                 placements)
from .. import kernel_scope, plain_backward
from . import kernel
from .chunked import wkv6_chunked, wkv6_decode_step
from .ref import wkv6_ref  # noqa: F401


class WKV6(torch.autograd.Function):
    """forward: ``kernel.wkv6`` → (y, final state); backward: autograd of
    ``wkv6_chunked`` at the same chunk, recomputed on the saved r, k, v,
    w, u, s0, for every input that needs a gradient. The final state's
    incoming gradient may be None (unused) or a tensor."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, chunk):
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return kernel.wkv6(r, k, v, w, u, s0=s0)

    @staticmethod
    def backward(ctx, dy, ds):
        def plain(r, k, v, w, u, s0):
            return wkv6_chunked(r, k, v, w, u, s0=s0, chunk=ctx.chunk)
        return plain_backward(plain, ctx, (dy, ds), 1)


def kernel_wkv6(r, k, v, w, u, s0=None, chunk: int = 32):
    """The kernel's route, differentiable: forward by the CUDA kernel,
    backward by the plain version (``chunk`` tiles its recompute)."""
    return WKV6.apply(r, k, v, w, u, s0, chunk)


def wkv6(r, k, v, w, u, s0=None, chunk: int = 32):
    """r/k/v/w (B,S,H,K), u (H,K), s0 (B,H,K,K) f32 or None →
    (y like r, final state f32). ``chunk`` tiles the plain version only:
    the kernel's bf16 path takes chunks of 32 steps on the tensor cores,
    its f32 path walks time one step at a time."""
    mesh = mesh_of(r, k, v, w, u, s0)
    if mesh is not None:
        sr = heads_specs(mesh, r)[0]
        dp, hd = sr[0], sr[2]
        specs = (sr, sr, sr, sr, Spec(hd, None),
                 None if s0 is None else Spec(dp, hd, None, None))
        return local_region(
            lambda *a: wkv6(*a, chunk=chunk), mesh, (r, k, v, w, u, s0),
            specs, (placements(sr, mesh),
                    placements(Spec(dp, hd, None, None), mesh)))
    with kernel_scope("wkv6"):
        if r.device.type == "cpu":
            return wkv6_chunked(r, k, v, w, u, s0=s0, chunk=chunk)
        return kernel_wkv6(r, k, v, w, u, s0=s0, chunk=chunk)


def wkv6_step(s, r, k, v, w, u):
    """Decode's one-token WKV step (``chunked.wkv6_decode_step``, plain
    PyTorch on every device): s (B,H,K,K) f32, r/k/v/w (B,H,K), u (H,K)
    → (y (B,H,K), new state). On DTensors, on the local shards (the
    batch over the data axes, the heads over ``model``)."""
    mesh = mesh_of(s, r, k, v, w, u)
    if mesh is None:
        return wkv6_decode_step(s, r, k, v, w, u)
    ss = heads_specs(mesh, s, heads_dim=1)[0]
    sr = Spec(*ss[:3])
    return local_region(wkv6_decode_step, mesh, (s, r, k, v, w, u),
                        (ss, sr, sr, sr, sr, Spec(ss[1], None)),
                        (placements(sr, mesh), placements(ss, mesh)))
