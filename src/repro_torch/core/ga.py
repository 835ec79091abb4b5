"""Genetic Algorithm scheduler — paper Sec. 6.2.

Genome (per candidate):
  * ``Px`` [n_ops, X], ``Py`` [n_ops, Y] — workload partitions, constrained
    to multiples of R (C) inside the Sec-6.2 window around uniform (±slack),
    with exact per-op sums.
  * ``collectors`` [n_ops] — collection-chiplet column for on-package
    redistribution (the second GA variable set named in the paper).
  * ``redist`` [n_ops] — whether to redistribute after op i (masked to
    semantically valid chain pairs).

Constraint-preserving operators:
  * crossover swaps whole per-op rows between parents (sums stay exact);
  * partition mutation moves one R-unit between two chiplet rows of the
    same op (sum invariant);
  * collector / redist mutations are uniform resamples.

Fitness is the vectorized evaluator over the whole population at once.

Two evolution engines (DESIGN.md §10):
  * ``engine="python"`` — the original per-individual offspring loop;
    the behavioral reference, with the fitness on either evaluator
    backend (``"numpy"``, ``"torch"`` or ``"auto"``).
  * ``engine="vectorized"`` — all genetic operators act on the whole
    population at once. With ``backend="numpy"`` this module's
    pure-numpy engine runs (bit for bit the JAX package's, from the same
    numpy RNG); with ``backend="torch"`` the device-resident engine
    (:mod:`.ga_torch`) keeps the genome on the card and runs fitness,
    selection, crossover and mutation there with one host sync per chunk
    of generations. The two vectorized paths share the same host-side
    population init but draw from different RNGs, so the contract
    across engines is property-based (exact per-op sums, domain
    windows, monotone best objective) plus fixed-seed solution-quality
    equivalence — not trajectory identity.

The port's copy of the JAX package's ``core/ga.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .evaluator import DEVICE_MODES  # noqa: F401 (re-exported)
from .evaluator import EvalOptions, Evaluator, resolve_auto_backend
from .hw import HWConfig
from .workload import (Partition, Task, clamp_partition_to_domain,
                       partition_domain, uniform_partition)

__all__ = ["DEVICE_MODES", "ENGINES", "GAConfig", "GAResult", "run_ga"]

ENGINES = ("python", "vectorized")

#: Attempts per rejection-sampled unit move (every engine).
MOVE_ATTEMPTS = 4


@dataclasses.dataclass(frozen=True)
class GAConfig:
    population: int = 96
    generations: int = 200
    elite: int = 4
    tournament: int = 3
    p_crossover: float = 0.85
    p_mutate_partition: float = 0.5
    p_mutate_collector: float = 0.2
    p_mutate_redist: float = 0.15
    slack: int = 2
    patience: int = 40          # early stop after this many flat generations
    seed: int = 0
    freeze_redist: bool = False  # force redistribution on all valid pairs
                                 # (planner: no shared-memory path exists)
    backend: str = "numpy"       # fitness backend: "numpy" | "torch" |
                                 # "auto" (torch at population >= 1024)
    device: str | None = None    # torch fitness device (None: the card)
    engine: str = "python"       # evolution engine: "python" | "vectorized"
                                 # (DESIGN.md §10)
    devices: str = "auto"        # island-axis execution of the device
                                 # engine: "single" | "sharded" | "auto"
                                 # (§15). Result-neutral: never part of
                                 # a cache fingerprint


@dataclasses.dataclass
class GAResult:
    partition: Partition
    redist_mask: np.ndarray
    objective: float
    history: np.ndarray         # best objective per generation
    evaluations: int


def _random_population(rng, task, hw, cfg, pop):
    """Seed: uniform partition + random unit moves (keeps diversity while
    starting near the feasible center, as the paper's window implies)."""
    n = len(task)
    X, Y = hw.X, hw.Y
    base = uniform_partition(task, X, Y)
    base = clamp_partition_to_domain(base, task, X, Y, hw.R, hw.C, cfg.slack)
    Px = np.repeat(base.Px[None], pop, axis=0).astype(np.int64)
    Py = np.repeat(base.Py[None], pop, axis=0).astype(np.int64)
    lo, hi = partition_domain(task, X, Y, hw.R, hw.C, cfg.slack)
    # Random unit moves per candidate (individual 0 stays uniform — elitism
    # guarantees GA can never be worse than the LS baseline partition).
    for p in range(1, pop):
        for i in range(n):
            for _ in range(rng.integers(0, X + Y)):
                _move_unit(rng, Px[p, i], hw.R, lo[i, 0], hi[i, 0])
                _move_unit(rng, Py[p, i], hw.C, lo[i, 1], hi[i, 1])
    coll = rng.integers(0, Y, size=(pop, n))
    coll[0] = Y // 2
    if cfg.freeze_redist:
        redist = np.ones((pop, n), dtype=bool)
    else:
        redist = rng.random((pop, n)) < 0.5
        redist[0] = True
    return Px, Py, coll.astype(np.int64), redist


def _random_population_vec(rng, task, hw, cfg, pop):
    """Vectorized-engine population init: same shape/spirit as
    :func:`_random_population` (uniform center, random unit moves,
    individual 0 stays uniform) but applies the moves to the whole
    ``[P, n]`` tensor per round instead of per individual. The device
    engine reuses this host-side init so both vectorized paths start from
    the identical population (RNG divergence begins at generation 0)."""
    n = len(task)
    X, Y = hw.X, hw.Y
    base = uniform_partition(task, X, Y)
    base = clamp_partition_to_domain(base, task, X, Y, hw.R, hw.C, cfg.slack)
    Px = np.repeat(base.Px[None], pop, axis=0).astype(np.int64)
    Py = np.repeat(base.Py[None], pop, axis=0).astype(np.int64)
    lo, hi = partition_domain(task, X, Y, hw.R, hw.C, cfg.slack)
    rounds = rng.integers(0, X + Y, size=(pop, n))
    rounds[0] = 0                       # individual 0 stays uniform
    for t in range(X + Y - 1):
        active = rounds > t
        _move_units_vec(rng, Px, hw.R, lo[:, 0], hi[:, 0], active)
        _move_units_vec(rng, Py, hw.C, lo[:, 1], hi[:, 1], active)
    coll = rng.integers(0, Y, size=(pop, n))
    coll[0] = Y // 2
    if cfg.freeze_redist:
        redist = np.ones((pop, n), dtype=bool)
    else:
        redist = rng.random((pop, n)) < 0.5
        redist[0] = True
    return Px, Py, coll.astype(np.int64), redist


def _move_unit(rng, row: np.ndarray, unit: int, lo: int, hi: int) -> None:
    """Move one ``unit`` from a donor entry to a receiver, in place,
    respecting the window — sum-preserving mutation. Rejection-samples a
    few times rather than materializing candidate sets (hot path)."""
    n = len(row)
    if n < 2:
        return
    for _ in range(MOVE_ATTEMPTS):
        d = int(rng.integers(n))
        r = int(rng.integers(n))
        if d == r:
            continue
        if row[d] - unit >= lo * unit and row[r] + unit <= hi * unit:
            row[d] -= unit
            row[r] += unit
            return


def _move_units_vec(rng, P_: np.ndarray, unit: int, lo: np.ndarray,
                    hi: np.ndarray, active: np.ndarray) -> None:
    """Population-wide sum-preserving unit move, in place.

    ``P_`` is ``[P, n, X]`` ints, ``lo``/``hi`` are per-op unit windows
    ``[n]``, ``active`` ``[P, n]`` selects which rows mutate. Rejection
    sampling runs over the whole tensor at once: each attempt draws a
    donor/receiver column per ``(p, i)`` and applies every row whose move
    is feasible; infeasible rows stay pending for the next attempt (the
    per-row semantics of :func:`_move_unit`, batched)."""
    P, n, X = P_.shape
    if X < 2:
        return
    pending = active.copy()
    for _ in range(MOVE_ATTEMPTS):
        if not pending.any():
            return
        d = rng.integers(0, X, size=(P, n))
        r = rng.integers(0, X, size=(P, n))
        dv = np.take_along_axis(P_, d[..., None], axis=-1)[..., 0]
        rv = np.take_along_axis(P_, r[..., None], axis=-1)[..., 0]
        ok = (pending & (d != r)
              & (dv - unit >= lo[None] * unit)
              & (rv + unit <= hi[None] * unit))
        pi, ni = np.nonzero(ok)
        P_[pi, ni, d[ok]] -= unit
        P_[pi, ni, r[ok]] += unit
        pending &= ~ok


def run_ga(
    task: Task,
    hw: HWConfig,
    objective: str = "latency",
    options: EvalOptions | None = None,
    cfg: GAConfig = GAConfig(),
    backend: str | None = None,
    engine: str | None = None,
) -> GAResult:
    """Run the Sec-6.2 GA. ``backend`` picks the fitness evaluator
    (``"numpy"``/``"torch"``/``"auto"``, torch on ``cfg.device``);
    ``engine`` picks the evolution loop (``"python"``/``"vectorized"``,
    DESIGN.md §10): ``"vectorized"`` on torch is the device engine
    (:func:`.ga_torch.run_ga_torch`). Both default to the
    :class:`GAConfig` fields."""
    if options is None:
        options = EvalOptions(redistribution=True, async_exec=True)
    engine = engine or cfg.engine
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
    backend = resolve_auto_backend(backend or cfg.backend, cfg.population)
    if engine == "vectorized":
        if backend == "torch":
            from . import ga_torch
            return ga_torch.run_ga_torch(task, hw, objective, options, cfg)
        return _run_ga_vectorized(task, hw, objective, options, cfg, backend)
    return _run_ga_python(task, hw, objective, options, cfg, backend)


def _run_ga_python(task, hw, objective, options, cfg, backend) -> GAResult:
    """Reference engine: per-individual offspring loop."""
    ev = Evaluator(task, hw, options, backend=backend, device=cfg.device)
    rng = np.random.default_rng(cfg.seed)
    n = len(task)
    X, Y = hw.X, hw.Y
    pop = cfg.population
    elite = min(cfg.elite, pop - 1)
    lo, hi = partition_domain(task, X, Y, hw.R, hw.C, cfg.slack)

    Px, Py, coll, redist = _random_population(rng, task, hw, cfg, pop)
    n_eval = 0
    history = []
    best = None  # (obj, genome)
    flat = 0

    for gen in range(cfg.generations):
        fit = ev.objective_batch(
            Px.astype(np.float64), Py.astype(np.float64), coll,
            redist.astype(np.float64), objective)
        n_eval += pop
        order = np.argsort(fit)
        gen_best = float(fit[order[0]])
        if best is None or gen_best < best[0] * (1.0 - 1e-4):
            flat = 0
        else:
            flat += 1
        if best is None or gen_best < best[0]:
            best = (gen_best, (Px[order[0]].copy(), Py[order[0]].copy(),
                               coll[order[0]].copy(), redist[order[0]].copy()))
        history.append(best[0])
        if flat >= cfg.patience:
            break

        # ---------------------------------------------------- next epoch
        nPx = np.empty_like(Px)
        nPy = np.empty_like(Py)
        nco = np.empty_like(coll)
        nrd = np.empty_like(redist)
        # elites
        for e in range(elite):
            j = order[e]
            nPx[e], nPy[e], nco[e], nrd[e] = Px[j], Py[j], coll[j], redist[j]
        # offspring
        for p in range(elite, pop):
            a = _tournament(rng, fit, cfg.tournament)
            b = _tournament(rng, fit, cfg.tournament)
            cPx, cPy = Px[a].copy(), Py[a].copy()
            cco, crd = coll[a].copy(), redist[a].copy()
            if rng.random() < cfg.p_crossover:
                mask = rng.random(n) < 0.5   # per-op uniform crossover
                cPx[mask] = Px[b][mask]
                cPy[mask] = Py[b][mask]
                cco[mask] = coll[b][mask]
                crd[mask] = redist[b][mask]
            # mutations
            for i in range(n):
                if rng.random() < cfg.p_mutate_partition:
                    _move_unit(rng, cPx[i], hw.R, lo[i, 0], hi[i, 0])
                if rng.random() < cfg.p_mutate_partition:
                    _move_unit(rng, cPy[i], hw.C, lo[i, 1], hi[i, 1])
                if rng.random() < cfg.p_mutate_collector:
                    cco[i] = rng.integers(0, Y)
                if not cfg.freeze_redist and \
                        rng.random() < cfg.p_mutate_redist:
                    crd[i] = not crd[i]
            nPx[p], nPy[p], nco[p], nrd[p] = cPx, cPy, cco, crd
        Px, Py, coll, redist = nPx, nPy, nco, nrd

    obj, (bPx, bPy, bco, brd) = best
    part = Partition(bPx, bPy, bco)
    part.validate(task)
    return GAResult(
        partition=part,
        redist_mask=brd & ev.chain_valid,
        objective=obj,
        history=np.array(history),
        evaluations=n_eval,
    )


def _run_ga_vectorized(task, hw, objective, options, cfg, backend
                       ) -> GAResult:
    """Vectorized engine, numpy RNG: every genetic operator acts on the
    whole population per generation — the host-side reference for the
    device-resident engine in :mod:`.ga_torch`."""
    ev = Evaluator(task, hw, options, backend=backend, device=cfg.device)
    rng = np.random.default_rng(cfg.seed)
    n = len(task)
    X, Y = hw.X, hw.Y
    pop = cfg.population
    elite = min(cfg.elite, pop - 1)
    Q = pop - elite
    lo, hi = partition_domain(task, X, Y, hw.R, hw.C, cfg.slack)

    Px, Py, coll, redist = _random_population_vec(rng, task, hw, cfg, pop)
    n_eval = 0
    history = []
    best = None
    flat = 0

    for gen in range(cfg.generations):
        fit = ev.objective_batch(
            Px.astype(np.float64), Py.astype(np.float64), coll,
            redist.astype(np.float64), objective)
        n_eval += pop
        order = np.argsort(fit)
        gen_best = float(fit[order[0]])
        if best is None or gen_best < best[0] * (1.0 - 1e-4):
            flat = 0
        else:
            flat += 1
        if best is None or gen_best < best[0]:
            best = (gen_best, (Px[order[0]].copy(), Py[order[0]].copy(),
                               coll[order[0]].copy(), redist[order[0]].copy()))
        history.append(best[0])
        if flat >= cfg.patience:
            break

        # --------------------------------------- next epoch, all at once
        a = _tournament_vec(rng, fit, cfg.tournament, Q)
        b = _tournament_vec(rng, fit, cfg.tournament, Q)
        mask = ((rng.random(Q) < cfg.p_crossover)[:, None]
                & (rng.random((Q, n)) < 0.5))      # per-op uniform crossover
        cPx = np.where(mask[..., None], Px[b], Px[a])
        cPy = np.where(mask[..., None], Py[b], Py[a])
        cco = np.where(mask, coll[b], coll[a])
        crd = np.where(mask, redist[b], redist[a])
        # mutations
        _move_units_vec(rng, cPx, hw.R, lo[:, 0], hi[:, 0],
                        rng.random((Q, n)) < cfg.p_mutate_partition)
        _move_units_vec(rng, cPy, hw.C, lo[:, 1], hi[:, 1],
                        rng.random((Q, n)) < cfg.p_mutate_partition)
        resample = rng.random((Q, n)) < cfg.p_mutate_collector
        cco = np.where(resample, rng.integers(0, Y, size=(Q, n)), cco)
        if not cfg.freeze_redist:
            flip = rng.random((Q, n)) < cfg.p_mutate_redist
            crd = np.where(flip, ~crd, crd)
        Px = np.concatenate([Px[order[:elite]], cPx])
        Py = np.concatenate([Py[order[:elite]], cPy])
        coll = np.concatenate([coll[order[:elite]], cco])
        redist = np.concatenate([redist[order[:elite]], crd])

    obj, (bPx, bPy, bco, brd) = best
    part = Partition(bPx, bPy, bco)
    part.validate(task)
    return GAResult(
        partition=part,
        redist_mask=brd & ev.chain_valid,
        objective=obj,
        history=np.array(history),
        evaluations=n_eval,
    )


def _tournament(rng, fit: np.ndarray, k: int) -> int:
    idx = rng.integers(0, len(fit), size=k)
    return int(idx[np.argmin(fit[idx])])


def _tournament_vec(rng, fit: np.ndarray, k: int, num: int) -> np.ndarray:
    """``num`` independent k-way tournaments in one draw: [num] winners."""
    idx = rng.integers(0, len(fit), size=(num, k))
    return idx[np.arange(num), np.argmin(fit[idx], axis=1)]
