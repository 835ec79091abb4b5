"""Public SSD-scan op: the CUDA kernel for CUDA tensors, the plain
chunked version for CPU tensors. There is no fallback: a kernel that
does not build or launch raises. ``ssm_scan_ref`` is the sequential
oracle for tests.

On CUDA tensors the kernel runs inside ``SSMScan``, an
``autograd.Function``: its forward is the kernel, its backward recomputes
the plain chunked version on the saved inputs and differentiates it (the
JAX package's training path differentiates the same chunked function,
rematerialised per chunk). On CPU tensors autograd differentiates the
plain version directly.
"""
from __future__ import annotations

import torch

from .. import plain_backward
from . import kernel
from .chunked import ssm_scan_chunked
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
    if x.device.type == "cpu":
        return ssm_scan_chunked(x, dt, a, Bmat, Cmat, D, h0=h0, chunk=chunk)
    return kernel_ssm_scan(x, dt, a, Bmat, Cmat, D, h0=h0, chunk=chunk)
