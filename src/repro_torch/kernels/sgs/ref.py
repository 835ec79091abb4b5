"""Plain PyTorch version of the batched SGS (``kernels/csrc/sgs_batch.cu``):
the CPU path of :func:`.ops.sgs_batch` and the kernel's oracle on the
card. The counterpart of the JAX package's ``sgs_instance`` under
``vmap`` (``src/repro/core/pipelining_jax.py:62``), step for step: a
Python loop of ``B * L`` frontier steps over all ``G`` points at once.
"""
from __future__ import annotations

import torch

_RES = (0, 1, 0)     # chain resource per position mod 3: NoP, array, NoP


def sgs_batch_ref(dur: torch.Tensor, prio: torch.Tensor, batch: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``dur``, ``prio`` float64 ``[G, L]`` (one sample's chain per grid
    point, priorities from ``chain_priorities``) → ``makespan [G]``,
    ``starts [G, batch, L]``: the serial heap SGS's schedule, the highest
    priority frontier job first, ties to the smallest job id
    ``s * L + p``."""
    G, L = dur.shape
    B = int(batch)
    dev = dur.device
    res = torch.tensor(_RES, device=dev)[torch.arange(L, device=dev) % 3]
    ptr = torch.zeros((G, B), dtype=torch.int64, device=dev)
    ready = torch.zeros((G, B), dtype=torch.float64, device=dev)
    free = torch.zeros((G, 2), dtype=torch.float64, device=dev)
    starts = torch.zeros((G, B, L), dtype=torch.float64, device=dev)
    base = torch.arange(B, device=dev) * L
    gi = torch.arange(G, device=dev)
    for _ in range(B * L):
        active = ptr < L
        pr = torch.where(active, prio.gather(1, ptr.clamp(max=L - 1)),
                         float("-inf"))
        cand = torch.where(active & (pr == pr.amax(1, keepdim=True)),
                           base + ptr, B * L)
        s = cand.argmin(1)
        p = ptr[gi, s]
        r = res[p]
        t0 = torch.maximum(ready[gi, s], free[gi, r])
        t1 = t0 + dur[gi, p]
        starts[gi, s, p] = t0
        ptr[gi, s] = p + 1
        ready[gi, s] = t1
        free[gi, r] = t1
    return free.amax(1), starts
