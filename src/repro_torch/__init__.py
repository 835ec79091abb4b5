"""PyTorch/CUDA port of the ``repro`` model-serving path for NVIDIA Hopper.

A package of its own beside the JAX package: it imports torch, numpy and
the standard library only. Entry points run on the card (``cuda``)
unless the caller passes ``device="cpu"``; on the CPU every kernel is
replaced by its plain PyTorch version.
"""
