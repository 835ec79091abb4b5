"""Public GEMM op: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors. There is no fallback: a kernel that does not build or
launch raises."""
from __future__ import annotations

from .kernel import matmul as matmul_kernel
from .ref import matmul_ref


def matmul(a, b):
    """a (M, K), b (K, N) → C (M, N) in a's dtype, summed in f32."""
    if a.device.type == "cpu":
        return matmul_ref(a, b)
    return matmul_kernel(a, b)
