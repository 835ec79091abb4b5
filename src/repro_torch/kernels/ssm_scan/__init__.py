"""Mamba-2 SSD scan: hand-written CUDA kernel, plain chunked version,
sequential oracle."""
