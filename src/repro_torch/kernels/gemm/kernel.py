"""Python wrapper of the hand-written CUDA GEMM (``kernels/csrc/gemm.cu``),
the port of the Pallas TPU kernel ``matmul`` in the JAX package:
C = A·B with f32 sums and C in the inputs' dtype.

The wrapper checks what the kernel takes and raises on anything else,
allocates C, and launches on PyTorch's current stream without
synchronising. ``matmul.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _fn():
    fn = _build.load("gemm").gemm_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _check(a, b):
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda":
            raise ValueError(
                f"matmul: {name} is on {t.device}; the kernel takes CUDA "
                "tensors (ops.matmul sends CPU tensors to the plain "
                "version)")
        if t.dim() != 2:
            raise ValueError(f"matmul: {name} must be 2-D, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"matmul: {name} must be contiguous "
                             "(row-major)")
    if a.device != b.device:
        raise ValueError("matmul: a and b on different devices")
    if a.dtype not in _DTYPES or a.dtype != b.dtype:
        raise ValueError("matmul: a and b must share one dtype of "
                         f"float32/bfloat16, got {a.dtype}, {b.dtype}")
    (M, K), (K2, N) = a.shape, b.shape
    if K != K2:
        raise ValueError(f"matmul: inner dims differ, a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}")
    if min(M, K, N) <= 0:
        raise ValueError(f"matmul: need nonempty sizes, got M={M} K={K} "
                         f"N={N}")


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K), b (K, N), one dtype of f32/bf16 → C (M, N) in that
    dtype."""
    _check(a, b)
    (M, K), N = a.shape, b.shape[1]
    fn = _fn()
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), _DTYPES[a.dtype],
                 M, N, K, stream)
    if err:
        raise RuntimeError(f"matmul: kernel launch failed with CUDA error "
                           f"{err}")
    matmul.launches += 1
    return c


matmul.launches = 0
