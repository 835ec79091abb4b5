"""Flash attention: hand-written CUDA kernel, plain blockwise version,
O(S²) oracle."""
