"""Public batched SGS op: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors. There is no fallback: a kernel that does not
build or launch raises."""
from __future__ import annotations

from .kernel import sgs_batch as sgs_batch_kernel
from .ref import sgs_batch_ref


def sgs_batch(dur, prio, batch):
    """``dur``, ``prio`` float64 ``[G, L]`` → ``makespan [G]``, ``starts
    [G, batch, L]``."""
    if dur.device.type == "cpu":
        return sgs_batch_ref(dur, prio, batch)
    return sgs_batch_kernel(dur, prio, batch)
