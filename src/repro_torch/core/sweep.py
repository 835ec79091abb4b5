"""Batched design-space sweep engine (DESIGN.md §9) — the port's copy of
the JAX package's ``core/sweep.py``, with ``"torch"`` where it has
``"jax"``.

Design-space exploration hammers the analytical evaluator across
(HWConfig × Task × EvalOptions) grids — Figs. 8–13 alone cover four
packaging types × four workloads × three solvers × multiple grid sizes.
This module turns those hand-rolled Python loops into:

  * :func:`grid` — generic named-axis cartesian product;
  * :func:`run_grid` — the timed per-point loop for work that stays
    per-point (the HiGHS ``engine="milp"`` path and other external
    solvers), with an optional per-point progress line;
  * :class:`EvalPoint` / :func:`eval_sweep` — batched evaluation: on the
    torch backend all uncached points whose shape signature (n_ops, X,
    Y, n_entrances) and options match are stacked along a grid axis and
    evaluated by ONE :func:`.evaluator_torch.grid_evaluate` call; the
    numpy backend loops per point and is the parity reference;
  * :func:`solve_grid` — batched solver searches: ``method="ga"``
    (DESIGN.md §10) evolves same-shape points as islands of one
    device-resident GA (:func:`.ga_torch.solve_islands`);
    ``method="miqp"`` (DESIGN.md §12) runs the lattice engine
    (:func:`.miqp_lattice.solve_lattice_batch`) with same-shape points
    sharing the grid axis of its scoring calls. The numpy backend runs
    the host engines per point and is the reference;
  * :class:`PipelinePoint` / :func:`pipeline_sweep` — batched RCPSP
    pipelining (DESIGN.md §13): same-(n_ops, batch) points schedule
    through one :func:`.pipelining_torch.schedule_batch` call (the
    hand-written SGS kernel on the card);
  * :func:`netsim_sweep` — batched flow simulation (DESIGN.md §11):
    same-mesh-shape nets run through one
    :func:`.netsim_torch.simulate_pull_batch` call (one launch of the
    hand-written waterfilling kernel on the card), with cached records;
  * :func:`cosearch_sweep` — the fused joint search (DESIGN.md §16):
    same-shape points evolve as islands of one co-search
    (:func:`.cosearch.cosearch_islands`), also reachable as
    ``solve_grid(method="cosearch")``;
  * :class:`MultiTenantPoint` / :func:`multitenant_sweep` — multi-tenant
    placement (DESIGN.md §18): several tasks on one package, searched
    by :func:`.multitenant.solve_multitenant`, also reachable as
    ``solve_grid(method="multitenant")``;
  * a process-wide result cache keyed by content fingerprints (backend +
    task ops + HWConfig + options + partition bytes for evaluation
    records; + objective and the full solver config — GAConfig or
    MIQPConfig, method-tagged — for solver records; segment-duration
    bytes + batch + the resolved PipelineConfig for pipelining records),
    so repeated baselines are evaluated once per backend. The torch
    backend's key carries the device type too: backends (and the card
    against the CPU) agree only to rtol 1e-9 and the GA engines draw
    from different generators, so records are not shared across them —
    results must not depend on evaluation order. A point's record never
    depends on the grid it was computed in (solo == batched, bit for
    bit), so the grid is never part of a key.

Two execution knobs ride on every sweep (DESIGN.md §15):

  * ``devices`` — ``"single" | "sharded" | "auto"`` splits each batched
    group's grid axis across a mesh of devices (:mod:`.sweep_shard`).
    Sharding is *result-neutral*: solo == batched == sharded bit for
    bit, so the knob is normalized out of every fingerprint
    (:func:`_strip_devices`) and one cache serves every mode;
  * ``checkpoint`` — a store path (or :class:`SweepCheckpointer`) makes
    the sweep persist its new cache records every ``checkpoint_every``
    points through :class:`repro_torch.serve.cache_store.CacheStore`.
    Kill the process anywhere and a rerun pointed at the same store
    resumes: completed points load back as cache hits, only the tail
    recomputes. ``straggler`` is any object with ``observe(chunk,
    seconds) -> bool``; a chunk it flags is reported on stderr.

The torch paths run on ``device`` (``None``: the card, raising without
one).

Typical use (LS baselines for one figure)::

    points = [EvalPoint(task, hw) for hw in hws for task in tasks]
    recs = eval_sweep(points)                  # one batched call
    recs[0]["latency"], recs[0]["edp"]
"""
from __future__ import annotations

import dataclasses
import itertools
import sys
import time
from typing import Any, Callable, Iterable, Sequence

import numpy as np

from ..device import resolve_device
from .evaluator import DEVICE_MODES, EvalOptions, Evaluator
from .hw import HWConfig
from .workload import Partition, Task, uniform_partition

__all__ = [
    "EvalPoint",
    "MultiTenantPoint",
    "PipelinePoint",
    "eval_sweep",
    "grid",
    "run_grid",
    "solve_grid",
    "cosearch_sweep",
    "netsim_sweep",
    "multitenant_sweep",
    "pipeline_sweep",
    "clear_cache",
    "cache_stats",
    "export_cache",
    "import_cache",
    "SweepCheckpointer",
]


# --------------------------------------------------------------- generic grid
def grid(**axes: Iterable) -> list[dict[str, Any]]:
    """Named-axis cartesian product: ``grid(a=[1,2], b="xy")`` →
    ``[{"a":1,"b":"x"}, {"a":1,"b":"y"}, ...]``. Axis order follows the
    keyword order, last axis fastest (matches nested-loop reading)."""
    names = list(axes)
    values = [list(axes[n]) for n in names]
    return [dict(zip(names, combo)) for combo in itertools.product(*values)]


def run_grid(
    points: Sequence[dict[str, Any]],
    fn: Callable[..., Any],
    emit: Callable[[dict, Any, float], None] | None = None,
    progress: bool | str = False,
    checkpoint=None,
    checkpoint_every: int = 1,
) -> list[tuple[dict, Any, float]]:
    """Timed per-point loop for sweeps whose body stays per-point —
    external-solver work such as the HiGHS ``engine="milp"`` MIQP path
    (batched MIQP lattice solves go through :func:`solve_grid` with
    ``method="miqp"`` and pipelining grids through :func:`pipeline_sweep`
    instead). Calls ``fn(**point)`` for every point, returning
    ``(point, result, microseconds)`` triples; ``emit`` (if given) is
    invoked per point for CSV-style reporting.

    ``progress`` writes a ``point i/N`` liveness line to **stderr**
    after each point — per-point solve time, aggregate points/sec, and
    an ETA for the remainder (pass a string to label the sweep).

    ``checkpoint`` (a store path or :class:`SweepCheckpointer`) flushes
    the process-wide result cache to disk every ``checkpoint_every``
    points: when ``fn`` runs cached sweeps internally, a killed grid
    resumes from the same store with completed points as cache hits."""
    label = progress if isinstance(progress, str) else "run_grid"
    ckpt = _resolve_checkpoint(checkpoint, checkpoint_every)
    out = []
    t_start = time.perf_counter()
    for i, pt in enumerate(points):
        t0 = time.perf_counter()
        res = fn(**pt)
        us = (time.perf_counter() - t0) * 1e6
        out.append((pt, res, us))
        if ckpt is not None and (i + 1) % ckpt.every == 0:
            ckpt.flush()
        if progress:
            done = i + 1
            elapsed = time.perf_counter() - t_start
            rate = done / elapsed if elapsed > 0 else float("inf")
            eta = (len(points) - done) / rate if rate > 0 else 0.0
            print(f"[sweep] {label} point {done}/{len(points)} "
                  f"{us:.0f}us ({rate:.1f} pts/s, eta {eta:.1f}s)",
                  file=sys.stderr)
        if emit is not None:
            emit(pt, res, us)
    if ckpt is not None:
        ckpt.flush()
    return out


# ----------------------------------------------------------- batched eval
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


def _check_devices(devices) -> None:
    """The §15 ``devices`` knob: ``None`` (defer to the point's options
    or the config) or one of :data:`.evaluator.DEVICE_MODES`."""
    if devices is not None and devices not in DEVICE_MODES:
        raise ValueError(f"bad devices {devices!r}; one of {DEVICE_MODES}")


def _strip_devices(obj):
    """Normalize the execution knobs out of a fingerprint component: the
    §15 ``devices`` mode is result-neutral, and the torch ``device``
    field of a solver config is keyed by its device type beside the
    backend instead (:func:`_backend_key`)."""
    if dataclasses.is_dataclass(obj):
        kw = {k: v for k, v in (("devices", "auto"), ("device", None))
              if hasattr(obj, k)}
        if kw:
            return dataclasses.replace(obj, **kw)
    return obj


def _backend_key(backend: str, device=None):
    """``"numpy"``, or ``("torch", device type)`` for the torch backend
    (resolving ``device``: ``None`` means the card)."""
    if backend == "torch":
        return ("torch", resolve_device(device).type)
    return backend


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
        _strip_devices(pt.options),
        part.Px.tobytes(), part.Py.tobytes(), part.collectors.tobytes(),
        rd,
    )


_CACHE: dict[tuple, Any] = {}
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


def _copy_cache_value(value):
    """Copy-by-value for any record family the cache holds: evaluation
    records are plain dicts (numpy arrays copied), solver records are
    ``GAResult``/``MIQPResult``/``PipelineResult`` dataclasses."""
    if isinstance(value, dict):
        return _copy_record(value)
    return _copy_solver_record(value)


def export_cache() -> dict[tuple, Any]:
    """Snapshot the process-wide result cache as ``{fingerprint: record}``
    (records copied by value — mutating the snapshot cannot poison the
    cache). The fingerprints are the exact cache keys, so a snapshot can
    be persisted (the port's ``serve/cache_store``) and re-imported in
    another process: a key either matches exactly or misses."""
    return {k: _copy_cache_value(v) for k, v in _CACHE.items()}


def import_cache(entries: dict, replace: bool = False) -> int:
    """Merge ``{fingerprint: record}`` entries (an :func:`export_cache`
    snapshot) into the process-wide cache; returns the number of entries
    inserted. Existing keys win unless ``replace=True`` — records are
    exact, so a collision is by construction the same result."""
    n = 0
    for k, v in entries.items():
        if replace or k not in _CACHE:
            _CACHE[k] = _copy_cache_value(v)
            n += 1
    return n


def _lookup(fps, records, todo, i, fp) -> None:
    """Cache probe for point ``i``: a hit fills ``records[i]``, a miss
    queues ``i`` in ``todo``."""
    fps[i] = fp
    hit = _CACHE.get(fp)
    if hit is not None:
        _STATS["hits"] += 1
        records[i] = _copy_cache_value(hit)
    else:
        _STATS["misses"] += 1
        todo.append(i)


# ------------------------------------------------- checkpointed resume
class SweepCheckpointer:
    """Periodic persistence of the §9 result cache to an on-disk
    :class:`repro_torch.serve.cache_store.CacheStore` (DESIGN.md §15).

    Construction *loads* the store into the process cache — a sweep
    pointed at the store of a killed run resumes with every completed
    point a cache hit — and remembers which fingerprints the store
    already holds. :meth:`flush` appends only the delta (cache entries
    not yet persisted); the store's append path tears at most the tail
    record on a crash, and its ``load`` drops a torn tail, so a kill at
    ANY instant costs at most one unflushed chunk of points.

    ``every`` is the flush cadence in points (sweep functions chunk the
    grid by it); ``resumed`` counts the records imported at construction.
    """

    def __init__(self, path, every: int = 8):
        from ..serve.cache_store import CacheStore

        self.store = path if isinstance(path, CacheStore) else \
            CacheStore(path)
        self.every = max(1, int(every))
        entries = self.store.load()
        self.resumed = import_cache(entries)
        self._persisted = set(entries)
        self.flushes = 0

    def pending(self) -> int:
        """Cache entries not yet persisted to the store."""
        return sum(1 for k in _CACHE if k not in self._persisted)

    def flush(self) -> int:
        """Append every unpersisted cache entry; returns the count."""
        new = {k: v for k, v in _CACHE.items()
               if k not in self._persisted}
        if new:
            self.store.append(new)
            self._persisted.update(new)
            self.flushes += 1
        return len(new)


def _resolve_checkpoint(checkpoint, every: int):
    if checkpoint is None or isinstance(checkpoint, SweepCheckpointer):
        return checkpoint
    return SweepCheckpointer(checkpoint, every=every)


def _checkpointed(points, checkpoint, every, cache, straggler, run_chunk):
    """Drive a batched sweep in checkpoint-sized chunks: each chunk's
    records land in the process cache (the sweep bodies insert them) and
    :meth:`SweepCheckpointer.flush` persists the delta, so a kill loses
    at most the in-flight chunk. ``straggler`` (any object with
    ``observe(chunk, seconds) -> bool``) observes per-chunk wall time;
    a chunk it flags is reported on stderr."""
    if not cache:
        raise ValueError("checkpointing requires cache=True — "
                         "records persist through the result cache")
    ckpt = _resolve_checkpoint(checkpoint, every)
    out = []
    for c, s in enumerate(range(0, len(points), ckpt.every)):
        chunk = points[s:s + ckpt.every]
        t0 = time.perf_counter()
        out.extend(run_chunk(chunk))
        dt = time.perf_counter() - t0
        ckpt.flush()
        if straggler is not None and straggler.observe(c, dt):
            print(f"[sweep] straggler: chunk {c} "
                  f"(points {s}:{s + len(chunk)}) took {dt:.3f}s",
                  file=sys.stderr)
    return out


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


def _shape_groups(points, idxs) -> dict[tuple, list[int]]:
    """Group point indices by shape signature (n_ops, X, Y,
    n_entrances) and options: one batched call per group."""
    groups: dict[tuple, list[int]] = {}
    for i in idxs:
        pt = points[i]
        sig = (len(pt.task), pt.hw.X, pt.hw.Y, pt.hw.topology.n_entrances,
               _strip_devices(pt.options))
        groups.setdefault(sig, []).append(i)
    return groups


def eval_sweep(
    points: Sequence[EvalPoint],
    backend: str = "torch",
    cache: bool = True,
    devices: str | None = None,
    checkpoint=None,
    checkpoint_every: int = 8,
    straggler=None,
    device=None,
) -> list[dict[str, Any]]:
    """Evaluate every point; returns records aligned with ``points``.

    Torch backend (on ``device``; ``None`` means the card): uncached
    points are grouped by shape signature + options and each group is
    evaluated in one call (consts and genomes stacked on a leading grid
    axis). Numpy backend: per-point reference loop — same records.

    ``devices`` (DESIGN.md §15) splits each group's grid axis across
    devices — result-neutral, see the module docstring; ``None`` defers
    to each group's ``options.devices``. ``checkpoint`` (a store path or
    :class:`SweepCheckpointer`) persists records every
    ``checkpoint_every`` points for kill/resume; requires ``cache=True``.
    """
    if backend not in ("numpy", "torch"):
        raise ValueError(f"unknown backend {backend!r}; "
                         f"one of ('numpy', 'torch')")
    _check_devices(devices)
    if checkpoint is not None:
        return _checkpointed(
            points, checkpoint, checkpoint_every, cache, straggler,
            lambda c: eval_sweep(c, backend=backend, cache=True,
                                 devices=devices, device=device))
    key = _backend_key(backend, device)
    records: list[dict[str, Any] | None] = [None] * len(points)
    todo: list[int] = []
    fps: list[tuple | None] = [None] * len(points)
    for i, pt in enumerate(points):
        if cache:
            _lookup(fps, records, todo, i, _point_fingerprint(pt, key))
        else:
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

        for idxs in _shape_groups(points, todo).values():
            evs = [Evaluator(points[i].task, points[i].hw, points[i].options)
                   for i in idxs]
            consts = [ev.consts() for ev in evs]
            stacked = {k: np.stack([c[k] for c in consts])
                       for k in consts[0]}
            genomes = [_genome(points[i], ev) for i, ev in zip(idxs, evs)]
            Px = np.stack([g[0] for g in genomes])[:, None]   # [G,1,n,X]
            Py = np.stack([g[1] for g in genomes])[:, None]
            co = np.stack([g[2] for g in genomes])[:, None]
            rd = np.stack([g[3] for g in genomes])[:, None]
            out = evaluator_torch.grid_evaluate(
                stacked, points[idxs[0]].options, Px, Py, co, rd, device,
                devices=(points[idxs[0]].options.devices
                         if devices is None else devices))
            for g, i in enumerate(idxs):
                records[i] = _record(points[i], out, (g, 0))

    if cache:
        for i in todo:
            _CACHE[fps[i]] = _copy_record(records[i])
    return records  # type: ignore[return-value]


# ------------------------------------------------------ batched netsim
def _rate_fp(v):
    """Fingerprint component for a scalar-or-array rate: heterogeneous
    per-chiplet capacities key by content bytes, scalars stay plain
    floats."""
    a = np.asarray(v, dtype=np.float64)
    return float(a) if a.ndim == 0 else a.tobytes()


def _netsim_fingerprint(net, message_bytes: float, backend) -> tuple:
    """``backend`` is ``"numpy"`` or ``("torch", device type)``."""
    ms = getattr(net, "mem_scale", None)
    return ("netsim", backend, net.X, net.Y, _rate_fp(net.bw_nop),
            float(net.bw_mem),
            None if ms is None else _rate_fp(ms),
            tuple(net.attach), float(message_bytes))


def netsim_sweep(
    nets: Sequence,
    message_bytes: float,
    backend: str = "torch",
    cache: bool = True,
    devices: str | None = None,
    checkpoint=None,
    checkpoint_every: int = 8,
    straggler=None,
    device=None,
) -> list[dict[str, Any]]:
    """Run the all-chiplets-pull flow simulation on every
    :class:`.netsim.MeshNet`; returns records aligned with ``nets``
    (DESIGN.md §11).

    Torch backend (on ``device``; ``None`` means the card): uncached
    nets are grouped by mesh shape (the :mod:`.topology` link space is a
    pure function of (X, Y) — capacities and attachment sets are data)
    and each group's whole (memory × placement × bandwidth) grid runs as
    ONE launch of the waterfilling kernel
    (:func:`.netsim_torch.simulate_pull_batch`). Numpy backend: the
    per-net vectorized host engine — the parity reference. Records carry
    ``latency`` (seconds), per-flow ``done`` times and per-link
    ``link_bytes`` over the dense link space, and share the process-wide
    result cache (fingerprint: backend, mesh shape, bandwidths,
    attachment set, message size).

    ``devices`` / ``checkpoint`` / ``straggler`` follow the §15 contract
    (module docstring)."""
    from . import netsim

    if backend not in ("numpy", "torch"):
        raise ValueError(f"unknown backend {backend!r}; "
                         f"one of ('numpy', 'torch')")
    _check_devices(devices)
    if checkpoint is not None:
        return _checkpointed(
            nets, checkpoint, checkpoint_every, cache, straggler,
            lambda c: netsim_sweep(c, message_bytes, backend=backend,
                                   cache=True, devices=devices,
                                   device=device))
    key = _backend_key(backend, device)
    records: list[dict[str, Any] | None] = [None] * len(nets)
    todo: list[int] = []
    fps: list[tuple | None] = [None] * len(nets)
    for i, net in enumerate(nets):
        if cache:
            _lookup(fps, records, todo, i,
                    _netsim_fingerprint(net, message_bytes, key))
        else:
            todo.append(i)

    if todo and backend == "numpy":
        for i in todo:
            net = nets[i]
            out = netsim.simulate_flows(
                net.pull_incidence(), net.link_caps(),
                np.full(net.X * net.Y, float(message_bytes)))
            records[i] = {"latency": float(out["latency"]),
                          "done": out["done"], "link_bytes": out["link_bytes"]}
    elif todo:
        from . import netsim_torch

        groups: dict[tuple, list[int]] = {}
        for i in todo:
            groups.setdefault((nets[i].X, nets[i].Y), []).append(i)
        for (X, Y), idxs in groups.items():
            caps = np.stack([nets[i].link_caps() for i in idxs])
            incs = np.stack([nets[i].pull_incidence() for i in idxs])
            msgs = np.full((len(idxs), X * Y), float(message_bytes))
            out = netsim_torch.simulate_pull_batch(
                caps, incs, msgs, device=device,
                devices="auto" if devices is None else devices)
            for g, i in enumerate(idxs):
                records[i] = {"latency": float(out["latency"][g]),
                              "done": out["done"][g],
                              "link_bytes": out["link_bytes"][g]}

    if cache:
        for i in todo:
            _CACHE[fps[i]] = _copy_record(records[i])
    return records  # type: ignore[return-value]


# ----------------------------------------------------------- batched solves
def _solver_fingerprint(pt: EvalPoint, method: str, backend,
                        objective: str, cfg) -> tuple:
    """Cache key for a solver search. The method tag and the full
    (frozen, hashable) solver config — GAConfig, MIQPConfig or
    PipelineConfig — are part of the key, so GA and MIQP records on the
    same point never collide and any hyperparameter change is a
    different record; so is the backend (with the torch device type):
    the GA engines draw from different generators and the lattice
    scorers agree only to rtol 1e-9 (arg-min ties could flip), so
    records must never be served across backends. The execution knobs
    are normalized out of the config (:func:`_strip_devices`)."""
    return (
        method, backend,
        _task_fingerprint(pt.task),
        pt.hw,
        _strip_devices(pt.options),
        objective,
        _strip_devices(cfg),
    )


def _copy_solver_record(rec):
    from .cosearch import CoSearchResult
    from .ga import GAResult
    from .miqp import MIQPResult
    from .multitenant import MultiTenantResult
    from .pipelining import PipelineResult

    if isinstance(rec, PipelineResult):
        return dataclasses.replace(rec)   # all fields immutable scalars
    if isinstance(rec, MultiTenantResult):
        return rec.copy()
    if isinstance(rec, CoSearchResult):
        return CoSearchResult(
            partition=rec.partition.copy(),
            redist_mask=rec.redist_mask.copy(),
            diagonal=rec.diagonal,
            seg_mask=rec.seg_mask.copy(),
            objective=rec.objective,
            edp=rec.edp,
            latency=rec.latency,
            energy=rec.energy,
            front={k: v.copy() for k, v in rec.front.items()},
            history=rec.history.copy(),
            evaluations=rec.evaluations,
        )
    if isinstance(rec, MIQPResult):
        return MIQPResult(
            partition=rec.partition.copy(),
            redist_mask=rec.redist_mask.copy(),
            objective=rec.objective,
            milp_status=rec.milp_status,
            milp_objective=rec.milp_objective,
            engine=rec.engine,
        )
    if isinstance(rec, GAResult):
        return GAResult(
            partition=rec.partition.copy(),
            redist_mask=rec.redist_mask.copy(),
            objective=rec.objective,
            history=rec.history.copy(),
            evaluations=rec.evaluations,
        )
    raise TypeError(f"not a sweep record: {type(rec).__name__}")


def solve_grid(
    points: Sequence[EvalPoint],
    objective: str = "latency",
    cfg=None,
    backend: str = "torch",
    cache: bool = True,
    method: str = "ga",
    devices: str | None = None,
    checkpoint=None,
    checkpoint_every: int = 8,
    straggler=None,
    device=None,
) -> list:
    """Run one solver search per point; returns records aligned with
    ``points`` — ``GAResult`` for ``method="ga"`` (DESIGN.md §10),
    ``MIQPResult`` for ``method="miqp"`` (DESIGN.md §12),
    ``CoSearchResult`` for ``method="cosearch"`` (DESIGN.md §16, routed
    to :func:`cosearch_sweep`).

    Torch backend: uncached points are grouped by shape signature —
    (n_ops, X, Y, n_entrances, options) — and each group batches through
    one program: GA searches evolve as *islands* of one device-resident
    GA (:func:`.ga_torch.solve_islands`); MIQP lattice searches share the
    grid axis of the chunked scoring calls
    (:func:`.miqp_lattice.solve_lattice_batch`). Numpy backend: per-point
    host engines (the GA's vectorized numpy engine). A point's result
    (and its cache record) is identical whether it is solved alone or
    batched with others: GA island draws depend only on ``cfg.seed``, and
    the lattice budgets are deterministic candidate counts.

    ``pt.partition`` / ``pt.redist_mask`` are ignored — a solve searches
    the genome space, it does not score a fixed schedule.
    ``backend="auto"`` resolves before fingerprinting (by
    ``cfg.population`` for GA, ``cfg.score_chunk`` for MIQP), so
    auto-resolved records share the cache with their concrete-backend
    equivalents; likewise ``MIQPConfig(engine="auto")`` resolves first.
    ``method="miqp"`` with ``engine="milp"`` cannot batch — those points
    run serially through :func:`.miqp.run_miqp` (still cached).

    ``method="multitenant"`` takes :class:`MultiTenantPoint` points and
    routes to :func:`multitenant_sweep`.

    ``device`` (``None``: the config's) is where the torch backend runs.
    ``devices`` / ``checkpoint`` / ``straggler`` follow the §15 contract
    (module docstring); ``devices=None`` defers to ``cfg.devices``."""
    _check_devices(devices)
    if method == "cosearch":
        return cosearch_sweep(points, objective=objective, cfg=cfg,
                              backend=backend, cache=cache,
                              devices=devices, checkpoint=checkpoint,
                              checkpoint_every=checkpoint_every,
                              straggler=straggler, device=device)
    if method == "multitenant":
        return multitenant_sweep(points, objective=objective, cfg=cfg,
                                 backend=backend, cache=cache,
                                 devices=devices, checkpoint=checkpoint,
                                 checkpoint_every=checkpoint_every,
                                 straggler=straggler, device=device)
    if method not in ("ga", "miqp"):
        raise ValueError(f"unknown method {method!r}; "
                         f"one of ('ga', 'miqp', 'cosearch', "
                         f"'multitenant')")
    if checkpoint is not None:
        return _checkpointed(
            points, checkpoint, checkpoint_every, cache, straggler,
            lambda c: solve_grid(c, objective, cfg, backend=backend,
                                 cache=True, method=method,
                                 devices=devices, device=device))
    if method == "miqp":
        return _solve_grid_miqp(points, objective, cfg, backend, cache,
                                devices, device)
    from .evaluator import resolve_auto_backend
    from .ga import GAConfig, run_ga

    if cfg is None:
        cfg = GAConfig()
    if device is not None:
        cfg = dataclasses.replace(cfg, device=device)
    if devices is not None:
        cfg = dataclasses.replace(cfg, devices=devices)
    backend = resolve_auto_backend(backend, cfg.population)
    if backend not in ("numpy", "torch"):
        raise ValueError(f"unknown backend {backend!r}; "
                         f"one of ('numpy', 'torch', 'auto')")
    key = _backend_key(backend, cfg.device)
    records: list = [None] * len(points)
    todo: list[int] = []
    fps: list[tuple | None] = [None] * len(points)
    for i, pt in enumerate(points):
        if cache:
            _lookup(fps, records, todo, i,
                    _solver_fingerprint(pt, "ga", key, objective, cfg))
        else:
            todo.append(i)

    if todo and backend == "numpy":
        for i in todo:
            pt = points[i]
            records[i] = run_ga(pt.task, pt.hw, objective, pt.options,
                                cfg, backend="numpy", engine="vectorized")
    elif todo:
        from . import ga_torch

        for idxs in _shape_groups(points, todo).values():
            outs = ga_torch.solve_islands(
                [points[i].task for i in idxs],
                [points[i].hw for i in idxs],
                points[idxs[0]].options, objective, cfg)
            for i, out in zip(idxs, outs):
                records[i] = out

    if cache:
        for i in todo:
            _CACHE[fps[i]] = _copy_solver_record(records[i])
    return records


def _solve_grid_miqp(points, objective, cfg, backend, cache,
                     devices=None, device=None) -> list:
    """``solve_grid`` body for ``method="miqp"`` (DESIGN.md §12)."""
    from .evaluator import resolve_auto_backend
    from .miqp import MIQPConfig, resolve_auto_engine, run_miqp

    if cfg is None:
        cfg = MIQPConfig()
    if devices is not None:
        cfg = dataclasses.replace(cfg, devices=devices)
    if device is not None:
        cfg = dataclasses.replace(cfg, device=device)
    engine = resolve_auto_engine(cfg.engine)
    backend = (resolve_auto_backend(backend, cfg.score_chunk)
               if engine == "lattice" else "numpy")
    if backend not in ("numpy", "torch"):
        raise ValueError(f"unknown backend {backend!r}; "
                         f"one of ('numpy', 'torch', 'auto')")
    # Fingerprint the *resolved* config so auto-selected records share
    # the cache with their concrete equivalents.
    cfg = dataclasses.replace(cfg, engine=engine, backend=backend)
    key = _backend_key(backend, cfg.device)
    records: list = [None] * len(points)
    todo: list[int] = []
    fps: list[tuple | None] = [None] * len(points)
    for i, pt in enumerate(points):
        if cache:
            _lookup(fps, records, todo, i,
                    _solver_fingerprint(pt, "miqp", key, objective, cfg))
        else:
            todo.append(i)

    if todo and (engine == "milp" or backend == "numpy"):
        # milp cannot batch; the numpy lattice is the per-point reference.
        for i in todo:
            pt = points[i]
            records[i] = run_miqp(pt.task, pt.hw, objective, pt.options,
                                  cfg, engine=engine)
    elif todo:
        from . import miqp_lattice

        for idxs in _shape_groups(points, todo).values():
            outs = miqp_lattice.solve_lattice_batch(
                [points[i].task for i in idxs],
                [points[i].hw for i in idxs],
                points[idxs[0]].options, objective, cfg)
            for i, out in zip(idxs, outs):
                records[i] = out

    if cache:
        for i in todo:
            _CACHE[fps[i]] = _copy_solver_record(records[i])
    return records


# ------------------------------------------------- batched co-search
def cosearch_sweep(
    points: Sequence[EvalPoint],
    objective: str = "edp",
    cfg=None,
    backend: str = "torch",
    cache: bool = True,
    devices: str | None = None,
    checkpoint=None,
    checkpoint_every: int = 8,
    straggler=None,
    device=None,
) -> list:
    """Run one fused joint search (partition × diagonal links × pipeline
    segmentation, DESIGN.md §16) per point; returns
    :class:`.cosearch.CoSearchResult` records aligned with ``points`` —
    also reachable as ``solve_grid(method="cosearch")``.

    Uncached points are grouped by shape signature — (n_ops, X, Y,
    n_entrances, options) — and each group evolves as islands of one
    batched co-search (:func:`.cosearch.cosearch_islands`) on ``device``
    (``None``: the config's, and its ``None`` the card). A point's
    record is identical solo or batched (island draws depend only on
    ``cfg.seed``, budgets are deterministic counts), so the §9 cache
    contract holds: records are method-tagged ``"cosearch"`` and keyed
    by the full frozen :class:`.cosearch.CoSearchConfig` and the device
    type.

    The diag gene *searches* the link axis, so ``pt.hw.diagonal_links``
    is normalized to ``False`` before fingerprinting and solving — plain
    and diagonal variants of the same mesh share one record.
    ``pt.partition`` / ``pt.redist_mask`` are ignored, like
    :func:`solve_grid`. Only the torch backend exists (the fitness
    chains the device engines end to end); ``backend="auto"`` resolves
    to it.

    ``devices`` (DESIGN.md §15) splits each group's island axis —
    result-neutral and fingerprint-invisible; ``None`` defers to
    ``cfg.devices``. ``checkpoint`` / ``checkpoint_every`` /
    ``straggler`` behave exactly like :func:`solve_grid`."""
    from .cosearch import CoSearchConfig, cosearch_islands

    _check_devices(devices)
    if cfg is None:
        cfg = CoSearchConfig()
    if not isinstance(cfg, CoSearchConfig):
        raise TypeError(f"cosearch_sweep needs a CoSearchConfig, "
                        f"got {type(cfg).__name__}")
    if backend == "auto":
        backend = "torch"
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r} for cosearch; "
                         f"the fused fitness only exists on 'torch' "
                         f"('auto' resolves to it)")
    if device is not None:
        cfg = dataclasses.replace(cfg, device=device)
    if devices is not None:
        cfg = dataclasses.replace(cfg, devices=devices)
    if checkpoint is not None:
        return _checkpointed(
            points, checkpoint, checkpoint_every, cache, straggler,
            lambda c: cosearch_sweep(c, objective, cfg, backend=backend,
                                     cache=True))
    key = _backend_key(backend, cfg.device)
    norm = [dataclasses.replace(
        pt, hw=dataclasses.replace(pt.hw, diagonal_links=False))
        for pt in points]
    records: list = [None] * len(points)
    todo: list[int] = []
    fps: list[tuple | None] = [None] * len(points)
    for i, pt in enumerate(norm):
        if cache:
            _lookup(fps, records, todo, i,
                    _solver_fingerprint(pt, "cosearch", key, objective,
                                        cfg))
        else:
            todo.append(i)

    for idxs in _shape_groups(norm, todo).values():
        outs = cosearch_islands([norm[i].task for i in idxs],
                                [norm[i].hw for i in idxs],
                                norm[idxs[0]].options, objective, cfg)
        for i, out in zip(idxs, outs):
            records[i] = out

    if cache:
        for i in todo:
            _CACHE[fps[i]] = _copy_solver_record(records[i])
    return records


# ---------------------------------------------- multi-tenant placement
@dataclasses.dataclass
class MultiTenantPoint:
    """One grid point of the multi-tenant placement sweep (DESIGN.md
    §18): several co-resident tasks on ONE (possibly heterogeneous)
    package, searched by ``solve_grid(method="multitenant")``."""

    tasks: tuple
    hw: HWConfig
    options: EvalOptions = EvalOptions()


def _multitenant_fingerprint(pt: MultiTenantPoint, backend,
                             objective: str, cfg) -> tuple:
    """Cache key for a multi-tenant search: tenant task tuple (order
    matters — bands are assigned in tenant order), the full hetero
    HWConfig, and the frozen config with the execution knobs stripped at
    both levels (the outer config and the nested inner-solver config).
    ``backend`` is ``"numpy"`` or ``("torch", device type)``
    (:func:`_backend_key`)."""
    inner = _strip_devices(cfg.cfg)
    return (
        "multitenant", backend,
        tuple(_task_fingerprint(t) for t in pt.tasks),
        pt.hw,
        _strip_devices(pt.options),
        objective,
        _strip_devices(dataclasses.replace(cfg, cfg=inner)),
    )


def multitenant_sweep(
    points: Sequence[MultiTenantPoint],
    objective: str = "edp",
    cfg=None,
    backend: str = "torch",
    cache: bool = True,
    devices: str | None = None,
    checkpoint=None,
    checkpoint_every: int = 8,
    straggler=None,
    device=None,
) -> list:
    """Run one multi-tenant placement search per point; returns
    :class:`.multitenant.MultiTenantResult` records aligned with
    ``points`` — also reachable as ``solve_grid(method="multitenant")``
    (DESIGN.md §18).

    The outer assignment loop is a host loop (band compositions are
    few); the inner per-tenant solves and exact re-scores go through
    :func:`solve_grid` / :func:`eval_sweep`, so they batch per region
    shape and share the process cache — identical region solves across
    assignments (and across points) dedupe to one engine call. On the
    torch backend every contention simulation of a point is one
    waterfilling launch. All budgets are deterministic counts, so
    records obey the §9 solo == batched == served contract.

    ``backend="auto"`` resolves to torch; ``device`` (``None``: the
    card) is where the torch backend runs. ``checkpoint`` / ``straggler``
    follow the §15 contract; ``devices`` threads through to the inner
    engines and is fingerprint-invisible."""
    from .multitenant import MultiTenantConfig, solve_multitenant

    if cfg is None:
        cfg = MultiTenantConfig()
    if not isinstance(cfg, MultiTenantConfig):
        raise TypeError(f"multitenant_sweep needs a MultiTenantConfig, "
                        f"got {type(cfg).__name__}")
    if backend == "auto":
        backend = "torch"
    if backend not in ("numpy", "torch"):
        raise ValueError(f"unknown backend {backend!r}; "
                         f"one of ('numpy', 'torch', 'auto')")
    _check_devices(devices)
    if checkpoint is not None:
        return _checkpointed(
            points, checkpoint, checkpoint_every, cache, straggler,
            lambda c: multitenant_sweep(c, objective, cfg,
                                        backend=backend, cache=True,
                                        devices=devices, device=device))
    key = _backend_key(backend, device)
    records: list = [None] * len(points)
    todo: list[int] = []
    fps: list[tuple | None] = [None] * len(points)
    for i, pt in enumerate(points):
        if cache:
            _lookup(fps, records, todo, i,
                    _multitenant_fingerprint(pt, key, objective, cfg))
        else:
            todo.append(i)

    for i in todo:
        pt = points[i]
        records[i] = solve_multitenant(
            pt.tasks, pt.hw, objective, pt.options, cfg,
            backend=backend, cache=cache, devices=devices, device=device)

    if cache:
        for i in todo:
            _CACHE[fps[i]] = _copy_solver_record(records[i])
    return records


# ------------------------------------------------- batched pipelining
@dataclasses.dataclass
class PipelinePoint:
    """One grid point of the batched RCPSP pipelining sweep
    (DESIGN.md §13): per-op ``(name, t_in, t_comp, t_out)`` segment
    durations for ONE sample (``EvalResult.segments()`` /
    ``ScheduleResult.segments()``) plus the batch size to pipeline."""

    segments: Sequence[tuple[str, float, float, float]]
    batch: int

    def durations(self) -> np.ndarray:
        """``[n_ops, 3]`` float64 durations, clamped like ``build_jobs``
        (one conversion shared with the engines, so the clamping
        contract — and the cache fingerprint built on it — cannot
        drift)."""
        from .pipelining import _segment_durations

        return _segment_durations(self.segments).reshape(-1, 3)


def _pipeline_fingerprint(pt: PipelinePoint, cfg, backend) -> tuple:
    """Cache key for a pipelining record: method tag, the resolved
    (frozen) :class:`~.pipelining.PipelineConfig` — engine and backend
    included — the backend key (with the torch device type),
    segment-duration bytes and batch. The engines are bit-identical
    (DESIGN.md §13), but the backend stays in the key for consistency
    with every other record family."""
    return ("pipeline", backend, _strip_devices(cfg),
            pt.durations().tobytes(), int(pt.batch))


def pipeline_sweep(
    points: Sequence[PipelinePoint],
    cfg=None,
    backend: str = "torch",
    cache: bool = True,
    devices: str | None = None,
    checkpoint=None,
    checkpoint_every: int = 8,
    straggler=None,
    device=None,
) -> list:
    """Schedule every pipelining point; returns
    :class:`~.pipelining.PipelineResult` records aligned with ``points``
    (DESIGN.md §13).

    Torch backend: uncached points are grouped by (n_ops, batch) — the
    chain structure is a pure function of that pair; durations are data
    — and each group schedules through ONE
    :func:`.pipelining_torch.schedule_batch` call (the SGS kernel on the
    card). A point's record is identical whether it is scheduled alone
    or batched (bit-identical, the §9 cache invariant).
    ``backend="numpy"`` runs the host frontier loop per point (the
    parity reference); ``engine="python"``/``"milp"`` configs run the
    serial engines per point — milp cannot batch — with records still
    cached. A non-``"auto"`` ``cfg.backend`` wins over the sweep-level
    ``backend`` argument (the :class:`PipelineConfig` contract);
    ``"auto"`` resolves to torch — grid batching always wins here, and
    the engines agree bit for bit, so the resolution is purely a
    performance choice.

    ``device`` (``None``: ``cfg.device``) is where the torch backend
    runs. ``devices`` / ``checkpoint`` / ``straggler`` follow the §15
    contract (module docstring); ``devices=None`` defers to
    ``cfg.devices``."""
    from .pipelining import (PipelineConfig, PipelineResult,
                             pipeline_batch, resolve_auto_pipeline_engine,
                             sequential_makespan)

    if cfg is None:
        cfg = PipelineConfig()
    if checkpoint is not None:
        return _checkpointed(
            points, checkpoint, checkpoint_every, cache, straggler,
            lambda c: pipeline_sweep(c, cfg, backend=backend, cache=True,
                                     devices=devices, device=device))
    if devices is not None:
        cfg = dataclasses.replace(cfg, devices=devices)
    if device is not None:
        cfg = dataclasses.replace(cfg, device=device)
    engine = resolve_auto_pipeline_engine(cfg.engine)
    # An explicit cfg.backend wins over the sweep-level default (the
    # PipelineConfig contract); "auto" resolves to torch here.
    backend = cfg.backend if cfg.backend != "auto" else backend
    backend = "torch" if backend == "auto" else backend
    if backend not in ("numpy", "torch"):
        raise ValueError(f"unknown backend {backend!r}; "
                         f"one of ('numpy', 'torch', 'auto')")
    if engine != "vectorized":
        backend = "numpy"        # serial engines run on host
    _check_devices(cfg.devices)
    # Fingerprint the *resolved* config so auto-selected records share
    # the cache with their concrete equivalents (the §12 rule).
    cfg = dataclasses.replace(cfg, engine=engine, backend=backend)
    key = _backend_key(backend, cfg.device)
    records: list = [None] * len(points)
    todo: list[int] = []
    fps: list[tuple | None] = [None] * len(points)
    for i, pt in enumerate(points):
        if cache:
            _lookup(fps, records, todo, i,
                    _pipeline_fingerprint(pt, cfg, key))
        else:
            todo.append(i)

    if todo and backend == "numpy":
        for i in todo:
            pt = points[i]
            records[i] = pipeline_batch(pt.segments, pt.batch, config=cfg)
    elif todo:
        from . import pipelining_torch

        groups: dict[tuple, list[int]] = {}
        for i in todo:
            pt = points[i]
            groups.setdefault((len(pt.segments), int(pt.batch)),
                              []).append(i)
        for (n, B), idxs in groups.items():
            durs = np.stack([points[i].durations() for i in idxs])
            out = pipelining_torch.schedule_batch(durs, B,
                                                  device=cfg.device,
                                                  devices=cfg.devices)
            for g, i in enumerate(idxs):
                records[i] = PipelineResult(
                    B, sequential_makespan(points[i].segments, B),
                    float(out["makespan"][g]), engine="vectorized")

    if cache:
        for i in todo:
            _CACHE[fps[i]] = _copy_solver_record(records[i])
    return records
