"""RWKV-6 WKV: hand-written CUDA kernel, plain chunked version, sequential
oracle."""
