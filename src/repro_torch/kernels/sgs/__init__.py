"""Batched SGS of the pipeliner: hand-written CUDA kernel and its plain
version."""
