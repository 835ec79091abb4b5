"""Batched evaluation sweeps with a process-wide result cache (DESIGN.md
§9) — the part of the JAX package's ``core/sweep.py`` that
:mod:`.api` needs.

  * :class:`EvalPoint` / :func:`eval_sweep` — batched evaluation: on the
    torch backend all uncached points whose shape signature (n_ops, X,
    Y, n_entrances) and options match are stacked along a grid axis and
    evaluated by ONE :func:`.evaluator_torch.grid_evaluate` call; the
    numpy backend loops per point and is the parity reference;
  * a process-wide result cache keyed by content fingerprints (backend +
    task ops + HWConfig + options + partition bytes), so repeated
    baselines are evaluated once per backend. The torch backend's key
    carries the device type too: backends (and the card against the
    CPU) agree only to rtol 1e-9, so records are not shared across them
    — results must not depend on evaluation order.

The JAX package's ``grid``, ``run_grid``, ``solve_grid``,
``pipeline_sweep``, ``SweepCheckpointer`` and its netsim, co-search and
multi-tenant sweeps come with ROADMAP.md A.1 and later items.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np

from ..device import resolve_device
from .evaluator import EvalOptions, Evaluator
from .hw import HWConfig
from .workload import Partition, Task, uniform_partition

__all__ = [
    "EvalPoint",
    "eval_sweep",
    "clear_cache",
    "cache_stats",
    "export_cache",
    "import_cache",
]


@dataclasses.dataclass
class EvalPoint:
    """One grid point of the batched evaluator sweep.

    ``partition=None`` means the LS-uniform partition (the baseline of
    every figure); ``redist_mask=None`` follows ``Evaluator.evaluate``:
    redistribute on every chained pair iff ``options.redistribution``.
    """

    task: Task
    hw: HWConfig
    options: EvalOptions = EvalOptions()
    partition: Partition | None = None
    redist_mask: np.ndarray | None = None

    def resolved_partition(self) -> Partition:
        if self.partition is not None:
            return self.partition
        return uniform_partition(self.task, self.hw.X, self.hw.Y)


def _task_fingerprint(task: Task) -> tuple:
    return (task.name, tuple(task.ops))


def _point_fingerprint(pt: EvalPoint, backend) -> tuple:
    """``backend`` is ``"numpy"`` or ``("torch", device type)``."""
    part = pt.resolved_partition()
    rd = (None if pt.redist_mask is None
          else np.asarray(pt.redist_mask, dtype=bool).tobytes())
    # backend is part of the key: the engines agree only to rtol 1e-9
    # (not bitwise), so sharing records across them would make results
    # depend on which backend touched a fingerprint first.
    return (
        backend,
        _task_fingerprint(pt.task),
        pt.hw,
        pt.options,
        part.Px.tobytes(), part.Py.tobytes(), part.collectors.tobytes(),
        rd,
    )


_CACHE: dict[tuple, dict[str, Any]] = {}
_STATS = {"hits": 0, "misses": 0}


def _copy_record(rec: dict[str, Any]) -> dict[str, Any]:
    """Records cross the cache boundary by value — callers mutating a
    returned record (or its arrays) must not poison the process cache."""
    return {k: (v.copy() if isinstance(v, np.ndarray) else v)
            for k, v in rec.items()}


def clear_cache() -> None:
    _CACHE.clear()
    _STATS["hits"] = _STATS["misses"] = 0


def cache_stats() -> dict[str, int]:
    return dict(_STATS)


def export_cache() -> dict[tuple, Any]:
    """Snapshot the process-wide result cache as ``{fingerprint: record}``
    (records copied by value — mutating the snapshot cannot poison the
    cache). The fingerprints are the exact cache keys, so a snapshot can
    be persisted (the port's ``serve/cache_store``) and re-imported in
    another process: a key either matches exactly or misses."""
    return {k: _copy_record(v) for k, v in _CACHE.items()}


def import_cache(entries: dict, replace: bool = False) -> int:
    """Merge ``{fingerprint: record}`` entries (an :func:`export_cache`
    snapshot) into the process-wide cache; returns the number of entries
    inserted. Existing keys win unless ``replace=True`` — records are
    exact, so a collision is by construction the same result."""
    n = 0
    for k, v in entries.items():
        if replace or k not in _CACHE:
            _CACHE[k] = _copy_record(v)
            n += 1
    return n


def _record(point: EvalPoint, out: dict[str, np.ndarray], i: int | tuple
            ) -> dict[str, Any]:
    """Extract one point's scalars/arrays from a batched output dict."""
    rec = {
        "task": point.task.name,
        "hw": point.hw,
        "options": point.options,
        "latency": float(out["latency"][i]),
        "energy": float(out["energy"][i]),
        "edp": float(out["edp"][i]),
        "t_in": np.asarray(out["t_in"][i]),
        "t_comp": np.asarray(out["t_comp"][i]),
        "t_out": np.asarray(out["t_out"][i]),
    }
    for k in ("E_sram", "E_mac", "E_mem", "E_nop"):
        rec[k] = float(out[k][i])
    return rec


def _genome(pt: EvalPoint, ev: Evaluator):
    part = pt.resolved_partition()
    if pt.redist_mask is None:
        rd = ev.chain_valid & pt.options.redistribution
    else:
        rd = np.asarray(pt.redist_mask, dtype=bool) & ev.chain_valid
        if not pt.options.redistribution:
            rd = np.zeros_like(rd)
    return (part.Px.astype(np.float64), part.Py.astype(np.float64),
            part.collectors.astype(np.float64), rd.astype(np.float64))


def eval_sweep(
    points: Sequence[EvalPoint],
    backend: str = "torch",
    cache: bool = True,
    device=None,
) -> list[dict[str, Any]]:
    """Evaluate every point; returns records aligned with ``points``.

    Torch backend (on ``device``; ``None`` means the card): uncached
    points are grouped by shape signature + options and each group is
    evaluated in one call (consts and genomes stacked on a leading grid
    axis). Numpy backend: per-point reference loop — same records.
    """
    if backend not in ("numpy", "torch"):
        raise ValueError(f"unknown backend {backend!r}; "
                         f"one of ('numpy', 'torch')")
    key = "numpy"
    if backend == "torch":
        device = resolve_device(device)
        key = ("torch", device.type)
    records: list[dict[str, Any] | None] = [None] * len(points)
    todo: list[int] = []
    fps: list[tuple | None] = [None] * len(points)
    for i, pt in enumerate(points):
        if cache:
            fp = _point_fingerprint(pt, key)
            fps[i] = fp
            hit = _CACHE.get(fp)
            if hit is not None:
                _STATS["hits"] += 1
                records[i] = _copy_record(hit)
                continue
            _STATS["misses"] += 1
        todo.append(i)

    if todo and backend == "numpy":
        for i in todo:
            pt = points[i]
            ev = Evaluator(pt.task, pt.hw, pt.options, backend="numpy")
            Px, Py, co, rd = _genome(pt, ev)
            out = ev.evaluate_batch(Px[None], Py[None], co[None], rd[None])
            records[i] = _record(pt, out, 0)
    elif todo:
        from . import evaluator_torch

        # Group by (shape signature, options): one batched call per group.
        groups: dict[tuple, list[int]] = {}
        evs: dict[int, Evaluator] = {}
        for i in todo:
            pt = points[i]
            ev = Evaluator(pt.task, pt.hw, pt.options)
            evs[i] = ev
            sig = (len(pt.task), pt.hw.X, pt.hw.Y, ev.top.n_entrances,
                   pt.options)
            groups.setdefault(sig, []).append(i)

        for sig, idxs in groups.items():
            consts = [evs[i].consts() for i in idxs]
            stacked = {k: np.stack([c[k] for c in consts])
                       for k in consts[0]}
            genomes = [_genome(points[i], evs[i]) for i in idxs]
            Px = np.stack([g[0] for g in genomes])[:, None]   # [G,1,n,X]
            Py = np.stack([g[1] for g in genomes])[:, None]
            co = np.stack([g[2] for g in genomes])[:, None]
            rd = np.stack([g[3] for g in genomes])[:, None]
            out = evaluator_torch.grid_evaluate(
                stacked, points[idxs[0]].options, Px, Py, co, rd, device)
            for g, i in enumerate(idxs):
                records[i] = _record(points[i], out, (g, 0))

    if cache:
        for i in todo:
            _CACHE[fps[i]] = _copy_record(records[i])
    return records  # type: ignore[return-value]
