"""SIMBA-like heuristic baseline — paper Sec. 3.1 / Table 3.

SIMBA partitions each layer non-uniformly, *inversely proportional to the
communication distance* of a chiplet (row/column) from off-chip memory,
greedily per layer with no end-to-end view. The paper shows this is
slightly *worse* than uniform LS when the end-to-end implication matters
(far chiplets get starved and under-utilized on compute-bound layers).

The port's copy of the JAX package's ``core/simba.py``, plain numpy.
"""
from __future__ import annotations

import numpy as np

from .hw import HWConfig
from .workload import Partition, Task, clamp_partition_to_domain

__all__ = ["simba_partition"]


def _inverse_distance_split(total: int, weights: np.ndarray, unit: int
                            ) -> np.ndarray:
    """Largest-remainder apportionment of ``total`` by ``weights``,
    snapped to multiples of ``unit`` where possible."""
    w = weights / weights.sum()
    raw = w * total
    base = np.floor(raw / unit).astype(np.int64) * unit
    resid = total - int(base.sum())
    # distribute the residual by largest fractional part, unit at a time
    order = np.argsort(-(raw - base))
    i = 0
    while resid >= unit:
        base[order[i % len(base)]] += unit
        resid -= unit
        i += 1
    base[order[0]] += resid  # sub-unit remainder
    return base


def simba_partition(task: Task, hw: HWConfig) -> Partition:
    top = hw.topology
    # Row/column distance = mean local distance of that grid row/col to its
    # entrance (generalizes the corner-memory case to types B/C/D).
    row_dist = top.x_local.mean(axis=1) + top.y_local.mean(axis=1) * 0.0
    col_dist = top.y_local.mean(axis=0)
    wx = 1.0 / (1.0 + row_dist)
    wy = 1.0 / (1.0 + col_dist)
    Px = np.stack(
        [_inverse_distance_split(op.M, wx, hw.R) for op in task.ops])
    Py = np.stack(
        [_inverse_distance_split(op.N, wy, hw.C) for op in task.ops])
    part = Partition(Px, Py, np.full(len(task), hw.Y // 2, dtype=np.int64))
    # SIMBA still respects systolic-utilization floors; project into the
    # same feasible domain the solvers use (slack chosen wide).
    part = clamp_partition_to_domain(part, task, hw.X, hw.Y, hw.R, hw.C,
                                     slack=2)
    part.validate(task)
    return part
