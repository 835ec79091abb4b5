"""Plain PyTorch GEMM: the CPU path and the on-card oracle of the CUDA
kernel. As the JAX package's ``matmul_ref``: both operands in f32, one
product, cast to ``a``'s dtype."""
from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() @ b.float()).to(a.dtype)
