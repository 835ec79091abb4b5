"""Python wrapper of the hand-written CUDA batched SGS
(``kernels/csrc/sgs_batch.cu``), the counterpart of the JAX package's
``sgs_instance`` under ``vmap`` (``src/repro/core/pipelining_jax.py:62``;
no Pallas kernel): one warp schedules one grid point's whole batch.

The wrapper checks what the kernel takes and raises on anything else,
allocates the outputs, and launches on PyTorch's current stream without
synchronising. ``sgs_batch.launches`` counts the launches.
``step_probe`` launches the kernel file's chain of empty warp-reduction
steps, the measured latency floor of one SGS step (not counted).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

#: Shared memory a block may use on Hopper (227 KB).
MAX_SMEM = 227 * 1024


@functools.cache
def _lib():
    lib = _build.load("sgs_batch")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sgs_batch.argtypes = [p, p, p, p, i, i, i, p]
    lib.sgs_batch.restype = ctypes.c_int
    lib.sgs_step_probe.argtypes = [p, i, p]
    lib.sgs_step_probe.restype = ctypes.c_int
    return lib


def _check(dur, prio, batch):
    for name, t in (("dur", dur), ("prio", prio)):
        if t.device.type != "cuda":
            raise ValueError(
                f"sgs_batch: {name} is on {t.device}; the kernel takes CUDA "
                "tensors (ops.sgs_batch sends CPU tensors to the plain "
                "version)")
        if t.dtype != torch.float64:
            raise ValueError(f"sgs_batch: {name} must be float64, got "
                             f"{t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"sgs_batch: {name} must be a contiguous "
                             f"[G, L] tensor, got {tuple(t.shape)}")
    if dur.shape != prio.shape or dur.device != prio.device:
        raise ValueError("sgs_batch: dur and prio differ in shape or "
                         f"device: {tuple(dur.shape)}, {tuple(prio.shape)}")
    G, L = dur.shape
    if min(G, L, batch) <= 0:
        raise ValueError(f"sgs_batch: need G, L and batch >= 1, got G={G} "
                         f"L={L} batch={batch}")
    if batch * L > (2**31 - 1) // 2:
        raise ValueError(f"sgs_batch: batch * L = {batch * L} is too many "
                         "jobs for int32 job ids")
    smem = 16 * L + 12 * batch
    if smem > MAX_SMEM:
        raise ValueError(f"sgs_batch: {smem} B of shared memory for L={L}, "
                         f"batch={batch}; a block has {MAX_SMEM}")


def sgs_batch(dur: torch.Tensor, prio: torch.Tensor, batch: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``dur``, ``prio`` float64 ``[G, L]`` on one card → ``makespan
    [G]``, ``starts [G, batch, L]``."""
    batch = int(batch)
    _check(dur, prio, batch)
    G, L = dur.shape
    lib = _lib()
    makespan = torch.empty(G, dtype=torch.float64, device=dur.device)
    starts = torch.empty((G, batch, L), dtype=torch.float64,
                         device=dur.device)
    with torch.cuda.device(dur.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sgs_batch(dur.data_ptr(), prio.data_ptr(),
                            makespan.data_ptr(), starts.data_ptr(), G,
                            batch, L, stream)
    if err:
        raise RuntimeError(f"sgs_batch: kernel launch failed with CUDA "
                           f"error {err}")
    sgs_batch.launches += 1
    return makespan, starts


sgs_batch.launches = 0


def step_probe(steps: int, device) -> torch.Tensor:
    """Launch ``steps`` empty warp-reduction steps (the SGS step's
    reductions, no dispatch) on ``device``; returns the kernel's output
    scalar so the work cannot be dropped."""
    out = torch.empty(1, dtype=torch.float64, device=device)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().sgs_step_probe(out.data_ptr(), int(steps), stream)
    if err:
        raise RuntimeError(f"sgs_step_probe: launch failed with CUDA error "
                           f"{err}")
    return out
