"""GEMM: hand-written CUDA kernel and its plain version."""
