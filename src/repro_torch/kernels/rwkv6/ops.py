"""Public WKV-6 op: the CUDA kernel for CUDA tensors, the plain chunked
version for CPU tensors. There is no fallback: a kernel that does not
build or launch raises. ``wkv6_ref`` is the sequential oracle for
tests."""
from __future__ import annotations

from .chunked import wkv6_chunked
from .kernel import wkv6 as wkv6_kernel
from .ref import wkv6_ref  # noqa: F401


def wkv6(r, k, v, w, u, s0=None, chunk: int = 32):
    """r/k/v/w (B,S,H,K), u (H,K), s0 (B,H,K,K) f32 or None →
    (y like r, final state f32). ``chunk`` tiles the plain version only:
    the kernel's bf16 path takes chunks of 32 steps on the tensor cores,
    its f32 path walks time one step at a time."""
    if r.device.type == "cpu":
        return wkv6_chunked(r, k, v, w, u, s0=s0, chunk=chunk)
    return wkv6_kernel(r, k, v, w, u, s0=s0)
