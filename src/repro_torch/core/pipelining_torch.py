"""torch backend for the RCPSP pipeliner — batched list scheduling
(DESIGN.md §13). The counterpart of the JAX package's
``core/pipelining_jax.py``.

The cross-sample pipelining DAG of Sec. 5.4 is *regular*: every sample of
a batch emits the same (in, comp, out) chain, so a whole instance is a
dense ``[batch, n_ops, 3]`` duration tensor and the serial heapq SGS of
:mod:`.pipelining` collapses into array form:

  * **Priorities** — a chain job's only successor is the next chain job,
    so the critical-path walk is a reversed cumulative sum, identical for
    every sample (:func:`.pipelining.chain_priorities`; computed on the
    host so every engine compares bit-identical floats on ties).
  * **Ready set = per-sample frontier** — scheduling a job makes its
    chain successor ready immediately, so the heap always holds exactly
    one entry (the next unscheduled chain position) per unfinished
    sample. The SGS step is therefore an ``argmax`` of priority over the
    ``[batch]`` frontier (ties → smallest jid, the heap's tie-break),
    dispatched onto its unit resource; ``batch × 3n`` such steps
    schedule the whole instance.
  * **Grids** — a leading grid axis batches every instance sharing
    (n_ops, batch) (:func:`.sweep.pipeline_sweep` does the grouping) into
    one call of :func:`repro_torch.kernels.sgs.ops.sgs_batch`: on the card
    the hand-written kernel (one warp per grid point runs all its steps),
    on the CPU its plain version. A solo call is the ``G = 1`` case, so
    solo == batched exactly (the §9 cache invariant).

Exactness: every arithmetic op (max, add) matches the serial engine bit
for bit — the contract is *bit-identical* makespans and start times.
``device=None`` means the card and raises without one.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.sgs import ops
from .pipelining import chain_priorities as host_chain_priorities

__all__ = ["chain_priorities", "schedule_batch", "sgs_instance",
           "sgs_makespan"]


def chain_priorities(dur: torch.Tensor) -> torch.Tensor:
    """Device form of :func:`.pipelining.chain_priorities` over the last
    axis (``[..., L]``): the reversed cumulative sum, for callers that
    build durations on the device (the co-search's fused fitness). The
    counterpart of the JAX package's ``chain_priorities_jnp``;
    :func:`schedule_batch` keeps the host form so its schedules stay
    bit-identical to the serial engine's."""
    return torch.flip(torch.cumsum(torch.flip(dur, (-1,)), -1), (-1,))


def sgs_makespan(dur: torch.Tensor, batch: int) -> torch.Tensor:
    """Makespans ``[R]`` of ``R`` chain instances ``dur [R, L]`` (float64,
    on any device) pipelined over ``batch`` samples: one call of
    :func:`repro_torch.kernels.sgs.ops.sgs_batch` with device-side
    priorities — on the card one kernel launch, no host copy and no
    sync. The durations are taken as they are (not clamped), as in the
    JAX package's fused ``sgs_instance(with_starts=False)``."""
    dur = dur.contiguous()
    makespan, _ = ops.sgs_batch(dur, chain_priorities(dur).contiguous(),
                                int(batch))
    return makespan


def _sgs(dur, prio, *, batch: int, device):
    """``dur [G, L]`` (clamped) and its chain priorities ``prio [G, L]``
    → device ``(makespan [G], starts [G, batch, L])`` through the op on
    ``device``."""
    dev = resolve_device(device)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return ops.sgs_batch(to(dur), to(prio), int(batch))


def sgs_instance(dur, batch: int, device=None) -> tuple[float, np.ndarray]:
    """One instance: ``dur [L]`` clamped chain durations of one sample →
    ``(makespan, starts [batch, L])`` — the ``G = 1`` case of
    :func:`schedule_batch` (``L == 0`` or ``batch == 0``: zeros)."""
    dur = np.asarray(dur, dtype=np.float64).reshape(1, -1)
    out = schedule_batch(dur.reshape(1, -1, 3), batch, device=device)
    return float(out["makespan"][0]), out["starts"][0]


def schedule_batch(segments_grid: np.ndarray, batch: int, device=None,
                   devices: str | None = "single"
                   ) -> dict[str, np.ndarray]:
    """Batched list scheduling: ``segments_grid [G, n, 3]`` per-op
    (t_in, t_comp, t_out) durations for ``G`` same-shape grid points →
    ``{"makespan": [G], "starts": [G, batch, 3n]}`` (``starts[g, s, p]``
    = start of sample ``s``'s p-th chain job, jid ``s*3n + p`` in
    :func:`.pipelining.build_jobs` order). One call of the batched SGS
    on ``device`` covers the whole group; ``devices`` (DESIGN.md §15)
    splits the grid axis over the mesh of :mod:`.sweep_shard`
    (``grid_mesh(device)``), one call a shard, with bit-identical
    schedules."""
    from . import sweep_shard

    seg = np.asarray(segments_grid, dtype=np.float64)
    G, n = seg.shape[0], seg.shape[1]
    L = 3 * n
    dur = np.maximum(seg.reshape(G, L) if L else np.zeros((G, 0)), 0.0)
    resolve_device(device)
    if L == 0 or batch == 0:
        return {"makespan": np.zeros(G), "starts": np.zeros((G, batch, L))}
    prio = np.stack([host_chain_priorities(d) for d in dur])
    if sweep_shard.resolve_devices(devices, G) == "sharded":
        makespan, starts = sweep_shard.sharded_grid_call(
            functools.partial(_sgs, batch=batch), (dur, prio),
            (True, True), G, mesh=sweep_shard.grid_mesh(device))
    else:
        makespan, starts = _sgs(dur, prio, batch=batch, device=device)
    return {"makespan": makespan.cpu().numpy(),
            "starts": starts.cpu().numpy()}
