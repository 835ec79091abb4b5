"""Public SSD-scan op: the CUDA kernel for CUDA tensors, the plain
chunked version for CPU tensors. There is no fallback: a kernel that
does not build or launch raises. ``ssm_scan_ref`` is the sequential
oracle for tests."""
from __future__ import annotations

from .chunked import ssm_scan_chunked
from .kernel import ssm_scan as ssm_scan_kernel
from .ref import ssm_scan_ref  # noqa: F401


def ssm_scan(x, dt, a, Bmat, Cmat, D, h0=None, chunk: int = 256):
    """x (B,S,H,P), dt (B,S,H) f32, a (H,), Bmat/Cmat (B,S,G,N), D (H,),
    h0 (B,H,P,N) f32 or None → (y like x, final state f32). ``chunk``
    tiles the plain version only: the kernel's bf16 path takes chunks of
    64 steps on the tensor cores, its f32 path walks time one step at a
    time."""
    if x.device.type == "cpu":
        return ssm_scan_chunked(x, dt, a, Bmat, Cmat, D, h0=h0, chunk=chunk)
    return ssm_scan_kernel(x, dt, a, Bmat, Cmat, D, h0=h0)
