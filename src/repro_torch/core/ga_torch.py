"""Device-resident GA engine — the whole evolution loop on the card
(DESIGN.md §10). The counterpart of the JAX package's
``core/ga_jax.py``.

The python/numpy engines in :mod:`.ga` pay a host↔device round trip per
generation (fitness on the device, genetic operators on the host). This
module keeps the whole genome tensor on the device and runs fitness +
tournament selection + per-op uniform crossover + sum-preserving
unit-move mutation + collector/redist resampling there, generation after
generation, with the host waiting for the device once per chunk of
``min(patience, remaining)`` generations:

  * **Genome layout on the device** — ``Px [G, P, n, X]``, ``Py [G, P, n,
    Y]``, ``collectors [G, P, n]``, ``redist [G, P, n]``, all float64
    (fitness needs float64 anyway and unit moves are exact in it). ``G``
    is the *island* axis: :func:`solve_islands` evolves many same-shape
    sweep points' searches through one batched step; a single
    :func:`run_ga_torch` search is its ``G = 1`` case, so per-point
    results are identical whether a point is solved alone or inside a
    grid (the sweep-cache invariant). The fitness reductions that are not
    exact (sums of float times over ops, chiplets and entrances) reduce
    along fixed per-point axes, never across islands.
  * **No host sync inside a chunk** — no ``.item()``, no ``nonzero()``,
    no one-argument ``torch.where``, no Python branch on a tensor: the
    host only enqueues. At the end of a chunk one device→host copy
    brings back the chunk's best-objective history, the early-stop flag
    and the best genomes, and the host decides whether to go on. Islands
    whose ``flat`` counter reached ``patience`` freeze: the step computes
    the next epoch but keeps the old carry, so a done island's
    history/best/evaluations are exactly what a solo early-stopped run
    would report.
  * **RNG** — an explicit ``torch.Generator`` on the island device,
    seeded by ``cfg.seed``; each generation makes three batched uniform
    draws (tournament, crossover and mutation, unit moves), shaped
    without the island axis and broadcast over it (islands differ
    through their fitness landscape, not their random draws — which
    keeps a point's trajectory independent of the grid it is solved
    in). The initial population comes from the shared numpy init
    (:func:`.ga._random_population_vec`), so both vectorized engines
    start identically; the CPU and CUDA generators give different
    streams, so the contract against the numpy engines is property-based
    plus fixed-seed solution quality (within 1%), not trajectory
    identity. At a fixed seed the engine is deterministic per device.

``device`` comes from ``cfg.device`` (``None``: the card, raising
without one; ``"cpu"`` runs the same code on the host).
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from . import evaluator_torch
from .evaluator import EvalOptions, Evaluator
from .ga import MOVE_ATTEMPTS
from .hw import HWConfig
from .workload import Partition, Task, partition_domain

__all__ = ["OBJECTIVES", "run_ga_torch", "solve_islands"]

#: Objectives the fused step can minimize (keys of the evaluator output).
OBJECTIVES = ("latency", "energy", "edp")

_F8 = torch.float64


def _move_units(u, P_, unit, lo, hi, active):
    """Device port of :func:`.ga._move_units_vec`: rejection-sampled
    sum-preserving unit moves over the whole ``[G, Q, n, X]`` tensor,
    four fixed attempts (the host engines' constant).

    ``u`` is a pre-drawn uniform block ``[2, MOVE_ATTEMPTS, Q, n]``
    (donor/receiver per attempt) shared by every island; ``unit`` is
    ``[G]``, ``lo``/``hi`` are ``[G, n]`` unit windows and ``active``
    ``[G, Q, n]`` selects the rows that mutate. Returns the new tensor."""
    G, Q, n, X = P_.shape
    if X < 2:
        return P_
    iota = torch.arange(X, device=P_.device)
    d_all = torch.floor(u[0] * X).long()
    r_all = torch.floor(u[1] * X).long()
    unit = unit[:, None, None]
    lo_u = lo[:, None, :] * unit
    hi_u = hi[:, None, :] * unit
    pending = active
    for t in range(MOVE_ATTEMPTS):
        d, r = d_all[t], r_all[t]                         # [Q, n]
        dm = (iota == d[..., None]).to(_F8)               # [Q, n, X]
        rm = (iota == r[..., None]).to(_F8)
        dv = (P_ * dm).sum(-1)                            # exact: one term
        rv = (P_ * rm).sum(-1)
        ok = (pending & (d != r)
              & (dv - unit >= lo_u) & (rv + unit <= hi_u))
        P_ = P_ + ok[..., None] * ((rm - dm) * unit[..., None])
        pending = pending & ~ok
    return P_


def _rows(A, idx):
    """``A [G, P, ...]`` rows ``idx [G, Q]`` per island → ``[G, Q, ...]``."""
    g = torch.arange(A.shape[0], device=A.device)[:, None]
    return A[g, idx]


def _draws(gen, cfg, Q, n, dev):
    """A generation's three batched uniform draws (tournaments, gene
    decisions, unit moves), shaped without the island axis, as JAX's
    ``random.uniform`` calls of ``ga_jax``'s step shape them."""
    return (torch.rand((2, Q, cfg.tournament), generator=gen, dtype=_F8,
                       device=dev),
            torch.rand((7, Q, n), generator=gen, dtype=_F8, device=dev),
            torch.rand((4, MOVE_ATTEMPTS, Q, n), generator=gen, dtype=_F8,
                       device=dev))


def _step(consts, win, cfg, opts, objective, elite, draws, carry):
    """One generation of every island: fitness + best tracking, then the
    next epoch from ``draws`` (``_draws``), then the freeze of done
    islands. ``carry`` is a dict of device tensors with a leading island
    axis; returns the new one."""
    Px, Py, co, rd = carry["Px"], carry["Py"], carry["co"], carry["rd"]
    G, pop, n, X = Px.shape
    Y = Py.shape[3]
    Q = pop - elite
    # steps > 0 mirrors the host engines' loop shape: generation 0
    # always evaluates (its history entry + best genome must exist), the
    # early-stop check runs after it — so patience <= 0 stops after
    # exactly one generation.
    done = (carry["flat"] >= cfg.patience) & (carry["steps"] > 0)

    # ---------------------------------------------------- fitness + best
    fit = evaluator_torch.evaluate_tensors(consts, opts, Px, Py, co,
                                           rd)[objective]        # [G, P]
    order = torch.argsort(fit, dim=1, stable=True)
    gi = order[:, :1]                                            # [G, 1]
    gen_best = fit.gather(1, gi)[:, 0]
    best_obj = carry["best_obj"]
    improved = gen_best < best_obj * (1.0 - 1e-4)
    better = gen_best < best_obj
    new = {
        "flat": torch.where(improved, 0, carry["flat"] + 1),
        "best_obj": torch.where(better, gen_best, best_obj),
        "steps": carry["steps"] + 1,
    }
    for k, A in (("bPx", Px), ("bPy", Py), ("bco", co), ("brd", rd)):
        old = carry[k]
        b = better.reshape((G,) + (1,) * (old.dim() - 1))
        new[k] = torch.where(b, _rows(A, gi)[:, 0], old)

    # ------------------------------------------- selection + crossover
    # Three batched uniform draws cover every random decision of the
    # generation.
    ut, um, uv = draws

    def tourney(u):                       # [Q, k] → winners [G, Q]
        idx = torch.floor(u * pop).long().expand(G, Q, cfg.tournament)
        f = fit.gather(1, idx.reshape(G, -1)).reshape(G, Q, -1)
        return idx.gather(2, torch.argmin(f, dim=2, keepdim=True))[..., 0]

    a = tourney(ut[0])
    b = tourney(ut[1])
    mask = (um[0, :, :1] < cfg.p_crossover) & (um[1] < 0.5)     # [Q, n]
    cPx = torch.where(mask[..., None], _rows(Px, b), _rows(Px, a))
    cPy = torch.where(mask[..., None], _rows(Py, b), _rows(Py, a))
    cco = torch.where(mask, _rows(co, b), _rows(co, a))
    crd = torch.where(mask, _rows(rd, b), _rows(rd, a))

    # ---------------------------------------------------------- mutations
    cPx = _move_units(uv[0:2], cPx, consts["R"], win["lo_x"], win["hi_x"],
                      (um[2] < cfg.p_mutate_partition).expand(G, Q, n))
    cPy = _move_units(uv[2:4], cPy, consts["C"], win["lo_y"], win["hi_y"],
                      (um[3] < cfg.p_mutate_partition).expand(G, Q, n))
    cco = torch.where(um[4] < cfg.p_mutate_collector,
                      torch.floor(um[5] * Y), cco)
    if not cfg.freeze_redist:
        crd = torch.where(um[6] < cfg.p_mutate_redist, 1.0 - crd, crd)

    top = order[:, :elite]
    new["Px"] = torch.cat([_rows(Px, top), cPx], dim=1)
    new["Py"] = torch.cat([_rows(Py, top), cPy], dim=1)
    new["co"] = torch.cat([_rows(co, top), cco], dim=1)
    new["rd"] = torch.cat([_rows(rd, top), crd], dim=1)
    # Freeze done islands: a finished search must report exactly what a
    # solo early-stopped run would (history length, best, counts).
    return {k: torch.where(done.reshape((G,) + (1,) * (v.dim() - 1)),
                           carry[k], v)
            for k, v in new.items()}


def _initial_population(tasks, hws, cfg, pop, seeds):
    """Each island's generation 0 (``Px, Py, collectors, redist`` numpy
    arrays): the shared host init, its RNG seeded by ``cfg.seed`` alone
    (so a point's result never depends on its position in the grid),
    with island ``g``'s rows ``1..`` replaced by ``seeds[g]``'s
    partitions when given."""
    from .ga import _random_population_vec

    inits = [_random_population_vec(np.random.default_rng(cfg.seed), t, h,
                                    cfg, pop)
             for t, h in zip(tasks, hws)]
    if seeds is not None:
        if len(seeds) != len(inits):
            raise ValueError(f"seeds must align with islands: "
                             f"{len(seeds)} != {len(inits)}")
        for g, props in enumerate(seeds):
            Px0, Py0 = inits[g][0], inits[g][1]
            for j, p in enumerate(props[:pop - 1]):
                Px0[j + 1] = p.Px
                Py0[j + 1] = p.Py
    return inits


def _evolve(consts, win, Px0, Py0, co0, rd0, *, cfg, options, objective,
            elite, device) -> dict[str, np.ndarray]:
    """Evolve the islands of one device: constants and unit windows
    ``[G, ...]`` and the initial population ``[G, P, ...]`` (float64) →
    numpy arrays ``steps [G]``, ``best_obj [G]``, the best
    genomes ``bPx [G, n, X]``, ``bPy [G, n, Y]``, ``bco``/``brd [G, n]``
    and the best-objective history ``hist [G, cfg.generations]`` (NaN
    past the last generation run). The host waits for the device once a
    chunk, for one packed copy."""
    dev = resolve_device(device)
    consts = evaluator_torch.to_device(consts, dev)
    win = {k: evaluator_torch.upload(v, dev) for k, v in win.items()}
    carry = {k: evaluator_torch.upload(a, dev) for k, a in
             (("Px", Px0), ("Py", Py0), ("co", co0), ("rd", rd0))}
    G, pop, n, X = carry["Px"].shape
    Y = carry["Py"].shape[3]
    carry.update({
        "best_obj": torch.full((G,), float("inf"), dtype=_F8, device=dev),
        "bPx": torch.zeros((G, n, X), dtype=_F8, device=dev),
        "bPy": torch.zeros((G, n, Y), dtype=_F8, device=dev),
        "bco": torch.zeros((G, n), dtype=_F8, device=dev),
        "brd": torch.zeros((G, n), dtype=_F8, device=dev),
        "flat": torch.zeros((G,), dtype=torch.int64, device=dev),
        "steps": torch.zeros((G,), dtype=torch.int64, device=dev),
    })
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(cfg.seed))

    best_hist = []
    gens_left = int(cfg.generations)
    chunk_len = max(1, min(int(cfg.patience), gens_left))
    host = None
    with torch.no_grad():
        while gens_left > 0:
            L = min(chunk_len, gens_left)
            hist = []
            for _ in range(L):
                draws = _draws(gen, cfg, pop - elite, n, dev)
                carry = _step(consts, win, cfg, options, objective, elite,
                              draws, carry)
                hist.append(carry["best_obj"])
            gens_left -= L
            # One device→host copy per chunk: the chunk's history, the
            # early-stop flag, the step counts and the best genomes.
            stop = (carry["flat"] >= cfg.patience).all()
            packed = torch.cat([
                torch.stack(hist, 1).reshape(-1), stop.to(_F8)[None],
                carry["steps"].to(_F8), carry["best_obj"],
                carry["bPx"].reshape(-1), carry["bPy"].reshape(-1),
                carry["bco"].reshape(-1), carry["brd"].reshape(-1)])
            host = packed.cpu().numpy()
            best_hist.append(host[:G * L].reshape(G, L))
            if host[G * L] > 0.5:
                break
    tail = host[G * L + 1:]
    sizes = (G, G, G * n * X, G * n * Y, G * n, G * n)
    steps, best_obj, bPx, bPy, bco, brd = np.split(
        tail, np.cumsum(sizes)[:-1])
    hist = np.full((G, int(cfg.generations)), np.nan)
    ran = np.concatenate(best_hist, axis=1)               # [G, T]
    hist[:, :ran.shape[1]] = ran
    return {"steps": steps, "best_obj": best_obj,
            "bPx": bPx.reshape(G, n, X), "bPy": bPy.reshape(G, n, Y),
            "bco": bco.reshape(G, n), "brd": brd.reshape(G, n),
            "hist": hist}


def solve_islands(
    tasks: Sequence[Task],
    hws: Sequence[HWConfig],
    options: EvalOptions,
    objective: str,
    cfg,
    devices: str | None = None,
    seeds: Sequence[Sequence[Partition]] | None = None,
) -> list:
    """Evolve one GA search per (task, hw) island through one batched
    generation step on ``cfg.device``. All islands must share a shape
    signature (n_ops, X, Y, n_entrances) — :func:`.sweep.solve_grid`
    does the grouping. Returns one :class:`.ga.GAResult` per island,
    aligned with the inputs.

    ``devices`` (default: ``cfg.devices``; DESIGN.md §15) splits the
    island axis over the mesh of :mod:`.sweep_shard`
    (``grid_mesh(cfg.device)``): each shard evolves on its own device
    with its own generator seeded by ``cfg.seed``, and since the draws
    are shaped without the island axis every island's record is bitwise
    the single-device one.

    ``seeds`` (optional, per island) warm-starts the search: island
    ``g``'s population rows ``1..`` are overwritten with the given
    :class:`Partition` proposals (row 0 keeps the uniform baseline, so a
    seeded run can never start worse than a cold one). Collector /
    redistribution genes of a seeded row keep their initial values —
    seeds speak only to the partition lattice. ``seeds=None`` keeps the
    cold-start init bit for bit."""
    from . import sweep_shard
    from .ga import GAResult

    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}; "
                         f"one of {OBJECTIVES}")
    devices = cfg.devices if devices is None else devices
    G = len(tasks)
    assert G == len(hws) and G > 0
    mode = sweep_shard.resolve_devices(devices, G)
    resolve_device(cfg.device)
    pop = cfg.population
    elite = min(cfg.elite, pop - 1)

    evs = [Evaluator(t, h, options, backend="numpy")
           for t, h in zip(tasks, hws)]
    keys0 = evs[0].consts().keys()
    consts = {k: np.stack([ev.consts()[k] for ev in evs]) for k in keys0}
    inits = _initial_population(tasks, hws, cfg, pop, seeds)
    win = {"lo_x": [], "hi_x": [], "lo_y": [], "hi_y": []}
    for t, h in zip(tasks, hws):
        lo, hi = partition_domain(t, h.X, h.Y, h.R, h.C, cfg.slack)
        win["lo_x"].append(lo[:, 0])
        win["hi_x"].append(hi[:, 0])
        win["lo_y"].append(lo[:, 1])
        win["hi_y"].append(hi[:, 1])
    win = {k: np.stack(v).astype(np.float64) for k, v in win.items()}
    pop0 = tuple(np.stack([init[i] for init in inits]).astype(np.float64)
                 for i in range(4))
    evolve = functools.partial(_evolve, cfg=cfg, options=options,
                               objective=objective, elite=elite)
    if mode == "sharded":
        out = sweep_shard.sharded_grid_call(
            evolve, (consts, win) + pop0, (True,) * 6, G,
            mesh=sweep_shard.grid_mesh(cfg.device))
    else:
        out = evolve(consts, win, *pop0, device=cfg.device)

    results = []
    for g in range(G):
        # steps[g] = generations actually evaluated; frozen tail steps of
        # the last chunk repeat the final state and are dropped.
        T = int(out["steps"][g])
        part = Partition(np.rint(out["bPx"][g]).astype(np.int64),
                         np.rint(out["bPy"][g]).astype(np.int64),
                         np.rint(out["bco"][g]).astype(np.int64))
        part.validate(tasks[g])
        results.append(GAResult(
            partition=part,
            redist_mask=(out["brd"][g] > 0.5) & evs[g].chain_valid,
            objective=float(out["best_obj"][g]),
            history=out["hist"][g, :T].copy(),
            evaluations=T * pop,
        ))
    return results


def run_ga_torch(task: Task, hw: HWConfig, objective: str,
                 options: EvalOptions, cfg):
    """Single-search entry point: the ``G = 1`` case of
    :func:`solve_islands` (the same step, so results match the island
    path exactly)."""
    return solve_islands([task], [hw], options, objective, cfg)[0]
