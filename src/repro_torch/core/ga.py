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

The port's copy of the JAX package's ``core/ga.py``: its reference
engine (the per-individual offspring loop, ``engine="python"``), with the
fitness on either evaluator backend (``"numpy"``, ``"torch"`` or
``"auto"``). The JAX package's vectorized and device-resident engines
(``engine="vectorized"``) come with ROADMAP.md A.2.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .evaluator import EvalOptions, Evaluator, resolve_auto_backend
from .hw import HWConfig
from .workload import (Partition, Task, clamp_partition_to_domain,
                       partition_domain, uniform_partition)

__all__ = ["ENGINES", "GAConfig", "GAResult", "run_ga"]

#: Evolution engines of the JAX package; the port runs "python" and
#: raises on "vectorized" (ROADMAP.md A.2).
ENGINES = ("python", "vectorized")

#: Attempts per rejection-sampled unit move.
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
    engine: str = "python"       # evolution engine: "python" (the port
                                 # has no "vectorized" yet, ROADMAP A.2)


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


def run_ga(
    task: Task,
    hw: HWConfig,
    objective: str = "latency",
    options: EvalOptions | None = None,
    cfg: GAConfig = GAConfig(),
    backend: str | None = None,
    engine: str | None = None,
) -> GAResult:
    """Run the Sec-6.2 GA: per-individual offspring loop. ``backend``
    picks the fitness evaluator (``"numpy"``/``"torch"``/``"auto"``, on
    ``cfg.device``); ``engine`` the evolution loop. Both default to the
    :class:`GAConfig` fields."""
    engine = engine or cfg.engine
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
    if engine == "vectorized":
        raise NotImplementedError(
            "GAConfig(engine='vectorized') needs the port's batched GA "
            "engines (ROADMAP.md A.2); use engine='python'")
    if options is None:
        options = EvalOptions(redistribution=True, async_exec=True)
    backend = resolve_auto_backend(backend or cfg.backend, cfg.population)
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


def _tournament(rng, fit: np.ndarray, k: int) -> int:
    idx = rng.integers(0, len(fit), size=k)
    return int(idx[np.argmin(fit[idx])])
