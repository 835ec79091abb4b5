"""Public SSD-scan op: the CUDA kernel for CUDA tensors, the plain
chunked version for CPU tensors. There is no fallback: a kernel that
does not build or launch raises. ``ssm_scan_ref`` is the sequential
oracle for tests.

On CUDA tensors the kernel runs inside ``SSMScan``, an
``autograd.Function``: its forward is the kernel, its backward recomputes
the plain chunked version on the saved inputs and differentiates it (the
JAX package's training path differentiates the same chunked function,
rematerialised per chunk). On CPU tensors autograd differentiates the
plain version directly. On DTensors the op runs on each rank's local
shard through ``local_map`` (the batch over the data axes, the heads over
``model``; the B and C groups whole), as ``flash_attention.ops.attention``
does.
"""
from __future__ import annotations

import torch

from ...sharding.logical import (Spec, heads_specs, local_region, mesh_of,
                                 placements)
from .. import kernel_scope, plain_backward
from . import kernel
from .chunked import ssm_decode_step, ssm_scan_chunked
from .ref import ssm_scan_ref  # noqa: F401


class SSMScan(torch.autograd.Function):
    """forward: ``kernel.ssm_scan`` → (y, final state); backward:
    autograd of ``ssm_scan_chunked`` at the same chunk, recomputed on the
    saved x, dt, a, B, C, D, h0, for every input that needs a gradient.
    The final state's incoming gradient may be None (unused) or a
    tensor."""

    @staticmethod
    def forward(ctx, x, dt, a, Bmat, Cmat, D, h0, chunk):
        ctx.save_for_backward(x, dt, a, Bmat, Cmat, D, h0)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return kernel.ssm_scan(x, dt, a, Bmat, Cmat, D, h0=h0)

    @staticmethod
    def backward(ctx, dy, dh):
        def plain(x, dt, a, Bmat, Cmat, D, h0):
            return ssm_scan_chunked(x, dt, a, Bmat, Cmat, D, h0=h0,
                                    chunk=ctx.chunk)
        return plain_backward(plain, ctx, (dy, dh), 1)


def kernel_ssm_scan(x, dt, a, Bmat, Cmat, D, h0=None, chunk: int = 256):
    """The kernel's route, differentiable: forward by the CUDA kernel,
    backward by the plain version (``chunk`` tiles its recompute)."""
    return SSMScan.apply(x, dt, a, Bmat, Cmat, D, h0, chunk)


def ssm_scan(x, dt, a, Bmat, Cmat, D, h0=None, chunk: int = 256):
    """x (B,S,H,P), dt (B,S,H) f32, a (H,), Bmat/Cmat (B,S,G,N), D (H,),
    h0 (B,H,P,N) f32 or None → (y like x, final state f32). ``chunk``
    tiles the plain version only: the kernel's bf16 path takes chunks of
    64 steps on the tensor cores, its f32 path walks time one step at a
    time."""
    mesh = mesh_of(x, dt, a, Bmat, Cmat, D, h0)
    if mesh is not None:
        sx = heads_specs(mesh, x)[0]
        dp, hd = sx[0], sx[2]
        sb = Spec(dp, None, None, None)
        specs = (sx, Spec(dp, None, hd), Spec(hd), sb, sb, Spec(hd),
                 None if h0 is None else Spec(dp, hd, None, None))
        return local_region(
            lambda *t: ssm_scan(*t, chunk=chunk), mesh,
            (x, dt, a, Bmat, Cmat, D, h0), specs,
            (placements(sx, mesh),
             placements(Spec(dp, hd, None, None), mesh)))
    with kernel_scope("ssm_scan"):
        if x.device.type == "cpu":
            return ssm_scan_chunked(x, dt, a, Bmat, Cmat, D, h0=h0,
                                    chunk=chunk)
        return kernel_ssm_scan(x, dt, a, Bmat, Cmat, D, h0=h0, chunk=chunk)


def ssm_step(h, x, dt, a, Bmat, Cmat, D):
    """Decode's one-token SSD step (``chunked.ssm_decode_step``, plain
    PyTorch on every device): h (B,H,P,N) f32, x (B,H,P), dt (B,H),
    Bmat/Cmat (B,G,N) → (y (B,H,P), new state). On DTensors, on the
    local shards (the batch over the data axes, the heads over
    ``model``)."""
    mesh = mesh_of(h, x, dt, a, Bmat, Cmat, D)
    if mesh is None:
        return ssm_decode_step(h, x, dt, a, Bmat, Cmat, D)
    sh = heads_specs(mesh, h, heads_dim=1)[0]
    dp, hd = sh[0], sh[1]
    sx = Spec(dp, hd, None)
    sb = Spec(dp, None, None)
    return local_region(ssm_decode_step, mesh, (h, x, dt, a, Bmat, Cmat, D),
                        (sh, sx, Spec(dp, hd), Spec(hd), sb, sb, Spec(hd)),
                        (placements(sx, mesh), placements(sh, mesh)))
