"""Batched max-min waterfilling netsim: hand-written CUDA kernel and its
plain version."""
