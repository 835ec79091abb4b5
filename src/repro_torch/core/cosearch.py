"""Fused cross-layer co-search on the card — one genome over partition ×
diagonal links × pipeline segmentation, with a Pareto archive on the
device (DESIGN.md §16). The port's counterpart of the JAX package's
``core/cosearch.py``, with the same names.

The paper optimizes partition (GA/MIQP), link configuration and the
pipeline schedule as separate passes. Here one genome spans all three
and one fused fitness scores it end to end, on float64 device tensors:

  * **Genome** — ``Px [n, X]`` / ``Py [n, Y]`` / ``collectors [n]`` /
    ``redist [n]`` (the GA genome, DESIGN.md §10) plus ``diag`` (one
    gene choosing the plain or the diagonal-link mesh) and ``seg [n]``
    (a boundary mask: ``seg[i]`` closes a pipeline segment after op
    ``i``; the last op's bit is ignored).
  * **Fused fitness** (:func:`_fitness`) — the mesh constants that the
    diagonal links change (:data:`DIAG_KEYS`) carry the population axis,
    chosen per candidate by its diag gene, so ONE
    :func:`.evaluator_torch.evaluate_tensors` call scores candidates on both
    meshes (under ``congestion="flow"`` the waterfilling work is not
    doubled: the flow network is the same on both meshes). The per-op
    ``(t_in, t_comp, t_out)`` phases merge into segment slots by a
    one-hot matrix product; then :func:`.pipelining_torch.sgs_makespan`
    schedules every candidate of every island at ``cfg.batch`` samples
    — on the card ONE launch of the hand-written SGS kernel a
    generation. Objective vector ``(EDP, latency, energy)`` with
    latency the pipelined per-sample time ``makespan / batch``.
  * **Pareto archive on the device** — each generation merges the
    population's objective vectors into a fixed-size archive
    (:func:`_archive_rank`: pairwise dominance, then a total order by
    (dominated, edp, latency, energy, index) built from stable sorts).
  * **Gradient seeds** (:func:`gradient_seeds`) — the partition lattice
    relaxes to a simplex (``softmax(logits) · M``) and the diag gene to
    a sigmoid; ``torch.autograd`` differentiates the smooth fitness
    (``evaluate_tensors(smooth=True)`` + the busiest-resource bound)
    through ``cfg.seed_steps`` normalized steps from
    ``cfg.seed_starts`` starts, and the rounded proposals seed the
    population and anchor the MIQP lattice (:func:`miqp_anchor`).

The generation loop (:func:`_evolve`) runs like the device GA's
(:mod:`.ga_torch`): every island of a shape group in one batched step,
no host sync inside a chunk of ``min(patience, remaining)``
generations, one device→host copy a chunk. A step is split into its
*draws* (:func:`_draws`: three uniform tensors from the island device's
generator, seeded by ``cfg.seed`` and shaped without the island axis)
and their *application* (:func:`_apply`), which takes the draws as
arguments. So a point's :class:`CoSearchResult` is bitwise identical
solo, batched or sharded (``devices=`` via :mod:`.sweep_shard`), and
:func:`.sweep.cosearch_sweep` caches records under method-tagged
fingerprints (§9). The CPU and CUDA generators give different streams:
the contract against the JAX package is value for value on the same
draws, and solution quality on a whole search.

Host-side Pareto utilities (:func:`dominates`, :func:`pareto_mask`,
:class:`ParetoArchive`) are copies of the JAX package's.
``cfg.device`` (``None``: the card, raising without one; ``"cpu"``)
is where the search runs.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from . import evaluator_torch, pipelining_torch
from .evaluator import EvalOptions, Evaluator
from .ga import MOVE_ATTEMPTS, _random_population_vec
from .ga_torch import _move_units, _rows
from .hw import HWConfig
from .workload import (Partition, Task, clamp_partition_to_domain,
                       partition_domain, uniform_partition)

__all__ = [
    "OBJECTIVES",
    "DIAG_KEYS",
    "CoSearchConfig",
    "CoSearchResult",
    "dominates",
    "pareto_mask",
    "ParetoArchive",
    "gradient_seeds",
    "cosearch_islands",
    "run_cosearch",
    "miqp_anchor",
]

#: Objective vector layout of the fused fitness (all minimized): EDP and
#: latency are *pipelined* (makespan / batch); energy is schedule-free.
OBJECTIVES = ("edp", "latency", "energy")

#: Evaluator-constant keys that differ between the plain and the
#: diagonal-link mesh (same shapes — entrances, masks and the flow
#: network do not depend on the links); the diag gene selects or, in
#: the smooth relaxation, interpolates exactly these.
DIAG_KEYS = ("hA", "hW", "h_min", "links")

# Carry tuple layout (every leaf has a leading island axis):
# (Px, Py, co, rd, diag, seg,                      population genes
#  arch_obj, aPx, aPy, aco, ard, adiag, aseg,      Pareto archive
#  best_obj, best_vec, bPx, bPy, bco, brd, bdiag, bseg,
#  flat, steps)
_BEST_OBJ, _BEST_VEC, _FLAT, _STEPS = 13, 14, 21, 22

_F8 = torch.float64


@dataclasses.dataclass(frozen=True)
class CoSearchConfig:
    """Hyperparameters of the joint search. Frozen + hashable — the full
    config is part of the §9 cache fingerprint and the serve-layer
    CallKey (``device`` and ``devices`` are normalized out of the
    fingerprint). Every budget is a deterministic count (generations,
    descent steps, archive slots), never wall-clock."""

    population: int = 64
    generations: int = 64
    elite: int = 4
    tournament: int = 3
    p_crossover: float = 0.85
    p_mutate_partition: float = 0.5
    p_mutate_collector: float = 0.2
    p_mutate_redist: float = 0.15
    p_mutate_diag: float = 0.15
    p_mutate_seg: float = 0.25
    slack: int = 2
    patience: int = 64
    seed: int = 0
    #: samples pipelined by the fused fitness (the fig11/fig13 batch).
    batch: int = 4
    #: extra comm-in seconds charged per active pipeline segment — a
    #: sync/drain cost that makes coarse segmentation non-free (0.0
    #: keeps the paper's free-segmentation reading).
    seg_overhead: float = 0.0
    #: device Pareto-archive capacity (finite rows become the front).
    archive_size: int = 32
    #: share of the population replaced by projected-gradient proposals
    #: (rows 2..; rows 0/1 stay the uniform partition on each mesh).
    seed_fraction: float = 0.25
    seed_steps: int = 32
    seed_lr: float = 0.3
    seed_starts: int = 4
    freeze_redist: bool = False
    backend: str = "torch"
    devices: str = "auto"
    #: torch device of the search (None: the card).
    device: str | None = None

    def __post_init__(self):
        if self.population < 2:
            raise ValueError("population must be >= 2")
        if self.archive_size < 1:
            raise ValueError("archive_size must be >= 1")
        if not 0.0 <= self.seed_fraction <= 1.0:
            raise ValueError("seed_fraction must be in [0, 1]")
        if self.batch < 1:
            raise ValueError("batch must be >= 1")
        if self.seg_overhead < 0.0:
            raise ValueError("seg_overhead must be >= 0")
        if self.seed_steps < 0 or self.seed_starts < 0:
            raise ValueError("seed_steps/seed_starts must be >= 0")


@dataclasses.dataclass
class CoSearchResult:
    """One point's joint-search result: the best genome on the scalar
    search objective plus the batched Pareto front.

    ``front`` maps ``"edp"/"latency"/"energy"`` to aligned ``[F]``
    arrays and carries the full genome per front row (``"Px" [F,n,X]``,
    ``"Py" [F,n,Y]``, ``"collectors"/"redist"/"seg" [F,n]``,
    ``"diag" [F]``), canonically sorted by (edp, latency, energy) and
    mutually non-dominated. The archive is bounded
    (``cfg.archive_size``), keeping lowest-EDP non-dominated rows — the
    *best* genome is tracked exactly and separately, like the GA's."""

    partition: Partition
    redist_mask: np.ndarray
    diagonal: bool
    seg_mask: np.ndarray
    objective: float
    edp: float
    latency: float
    energy: float
    front: dict[str, np.ndarray]
    history: np.ndarray
    evaluations: int


# ------------------------------------------------ host Pareto utilities
def dominates(a, b) -> bool:
    """Strict Pareto dominance (minimization): every component of ``a``
    <= the matching component of ``b`` and at least one strictly <."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return bool(np.all(a <= b) and np.any(a < b))


def pareto_mask(points) -> np.ndarray:
    """``[N] bool`` — non-dominated rows of ``points [N, d]``, with exact
    duplicates keeping only their first occurrence (so the masked set is
    a minimal front: no member dominates or equals another)."""
    pts = np.asarray(points, dtype=np.float64)
    if pts.ndim != 2:
        pts = pts.reshape(len(pts), -1)
    N = len(pts)
    le = np.all(pts[:, None, :] <= pts[None, :, :], axis=-1)
    lt = np.any(pts[:, None, :] < pts[None, :, :], axis=-1)
    dominated = np.any(le & lt, axis=0)
    eq = np.all(pts[:, None, :] == pts[None, :, :], axis=-1)
    idx = np.arange(N)
    dup = np.any(eq & (idx[:, None] < idx[None, :]), axis=0)
    return ~(dominated | dup)


class ParetoArchive:
    """Host mirror of the device archive: insert points, read the front.

    The archive keeps every non-dominated point (pruning newly dominated
    members on insert); :meth:`front` returns the canonical
    (value-sorted) front, optionally truncated to ``k`` rows by the same
    lowest-first rule the device archive uses. Membership is a pure
    function of the *set* of inserted points, so the front does not
    depend on insertion order."""

    def __init__(self):
        self._points: list[tuple[np.ndarray, object]] = []

    def __len__(self) -> int:
        return len(self._points)

    def insert(self, point, payload=None) -> bool:
        """Add ``point`` (any 1-D objective vector); returns True if it
        joined the archive (i.e. no member dominates or equals it)."""
        p = np.asarray(point, dtype=np.float64).ravel()
        for q, _ in self._points:
            if dominates(q, p) or np.array_equal(q, p):
                return False
        self._points = [(q, pl) for q, pl in self._points
                        if not dominates(p, q)]
        self._points.append((p, payload))
        return True

    def front(self, k: int | None = None) -> np.ndarray:
        """``[F, d]`` front rows, sorted lexicographically by objective
        value; ``k`` keeps the first ``k`` rows (the device archive's
        deterministic truncation rule)."""
        if not self._points:
            return np.zeros((0, 0))
        pts = np.stack([p for p, _ in self._points])
        order = np.lexsort(tuple(pts[:, j]
                                 for j in range(pts.shape[1] - 1, -1, -1)))
        pts = pts[order]
        return pts if k is None else pts[:k]

    def payloads(self, k: int | None = None) -> list:
        """Payloads aligned with :meth:`front` rows."""
        if not self._points:
            return []
        pts = np.stack([p for p, _ in self._points])
        order = np.lexsort(tuple(pts[:, j]
                                 for j in range(pts.shape[1] - 1, -1, -1)))
        out = [self._points[i][1] for i in order]
        return out if k is None else out[:k]


# ----------------------------------------------------- device fitness
def _archive_rank(obj: torch.Tensor) -> torch.Tensor:
    """``obj [..., Nc, 3]`` → index order ``[..., Nc]`` per leading
    index: non-dominated rows first (exact duplicates keep the lowest
    index), then by (edp, latency, energy, index) — a total order, so
    archive truncation is reproducible and lane-independent. Empty slots
    travel as +inf rows: any finite row dominates them and they sort
    last. torch has no ``lexsort``, so the order is built by stable
    sorts from the last key (the index) to the first (dominated)."""
    Nc = obj.shape[-2]
    a, b = obj[..., :, None, :], obj[..., None, :, :]
    le = (a <= b).all(-1)
    lt = (a < b).any(-1)
    dominated = (le & lt).any(-2)
    eq = (a == b).all(-1)
    idx = torch.arange(Nc, device=obj.device)
    dup = (eq & (idx[:, None] < idx[None, :])).any(-2)
    bad = (dominated | dup).to(torch.int64)
    order = idx.expand(obj.shape[:-1]).contiguous()
    for key in (obj[..., 2], obj[..., 1], obj[..., 0], bad):
        pos = torch.sort(key.gather(-1, order), dim=-1, stable=True)[1]
        order = order.gather(-1, pos)
    return order


def _mesh_consts(cp, cd, dg, smooth: bool) -> dict[str, torch.Tensor]:
    """The evaluator's constants for candidates ``dg [G, P]``: ``cp``'s,
    with the :data:`DIAG_KEYS` gaining the population axis — ``cd``'s
    where ``dg > 0.5`` (search), or ``(1 - dg)·cp + dg·cd`` (smooth)."""
    c = dict(cp)
    G, P = dg.shape
    for k in DIAG_KEYS:
        w = dg.reshape((G, P) + (1,) * (cp[k].dim() - 1))
        plain, diag = cp[k][:, None], cd[k][:, None]
        c[k] = ((1.0 - w) * plain + w * diag if smooth
                else torch.where(w > 0.5, diag, plain))
    return c


def _fitness(cp, cd, seg_overhead: float, Px, Py, co, rd, dg, sg, *,
             batch: int, options: EvalOptions, smooth: bool
             ) -> torch.Tensor:
    """The fused fitness of every candidate: constant bundles ``cp``
    (plain mesh) and ``cd`` (diagonal mesh, :data:`DIAG_KEYS` at least)
    ``[G, ...]``, genes ``Px [G, P, n, X]``, ``Py [G, P, n, Y]``,
    ``co``/``rd``/``sg`` ``[G, P, n]`` and ``dg [G, P]`` → objective
    vectors ``[G, P, 3]`` (:data:`OBJECTIVES` order). ``smooth=True``
    is the differentiable relaxation of the gradient seeds: the diag
    gene interpolates, the tile counts relax, and the SGS makespan
    becomes the busiest-resource bound ``max(B·Σcomm, B·Σcomp, Σt)``."""
    G, P, n, _ = Px.shape
    out = evaluator_torch.evaluate_tensors(
        _mesh_consts(cp, cd, dg, smooth), options, Px, Py, co, rd,
        smooth=smooth)
    # Segment merge: seg[i] opens a boundary after op i (the last op's
    # bit is ignored), ops map to slots by cumulative boundary count,
    # and a one-hot matrix product folds per-op phases into per-slot
    # (t_in, t_comp, t_out). Empty slots are zero-duration jobs.
    dt, dev = Px.dtype, Px.device
    notlast = torch.cat([torch.ones(n - 1, dtype=dt, device=dev),
                         torch.zeros(1, dtype=dt, device=dev)])
    b = sg * notlast
    seg_id = torch.cumsum(torch.cat([torch.zeros_like(b[..., :1]),
                                     b[..., :-1]], -1), -1)
    onehot = (seg_id[..., :, None]
              == torch.arange(n, device=dev)).to(dt)     # [G, P, op, slot]
    phases = torch.stack([out["t_in"], out["t_comp"], out["t_out"]], -1)
    slot = onehot.transpose(-1, -2) @ phases              # [G, P, n, 3]
    active = torch.sign(onehot.sum(-2))                   # [G, P, n]
    # The overhead goes on each active slot's t_in (JAX adds it times
    # (1, 0, 0): the same sums, since x + 0.0 == x).
    slot = torch.cat([slot[..., :1] + (seg_overhead * active)[..., None],
                      slot[..., 1:]], -1)
    dur = slot.reshape(G, P, 3 * n)
    if smooth:
        # Busiest-resource lower bound — exact when one resource
        # saturates, differentiable everywhere.
        comm = dur[..., 0::3].sum(-1) + dur[..., 2::3].sum(-1)
        comp = dur[..., 1::3].sum(-1)
        makespan = torch.maximum(
            torch.maximum(batch * comm, batch * comp), dur.sum(-1))
    else:
        makespan = pipelining_torch.sgs_makespan(
            dur.reshape(G * P, 3 * n), batch).reshape(G, P)
    lat = makespan / float(batch)
    energy = out["energy"]
    return torch.stack([energy * lat, lat, energy], -1)


# -------------------------------------------------- the generation step
def _draws(gen: torch.Generator, Q: int, n: int, tournament: int,
           device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One generation's random numbers, shaped without the island axis
    (islands differ through their landscape, not their draws): the
    tournament ``[2, Q, tournament]``, the crossover and mutation
    decisions ``[10, Q, n]`` and the unit moves ``[4, MOVE_ATTEMPTS, Q,
    n]``, in that order from ``gen``."""
    def u(shape):
        return torch.rand(shape, generator=gen, dtype=_F8, device=device)
    return (u((2, Q, tournament)), u((10, Q, n)),
            u((4, MOVE_ATTEMPTS, Q, n)))


def _apply(cp, cd, win, carry: tuple, draws, *, cfg: CoSearchConfig,
           options: EvalOptions, obj_idx: int, elite: int) -> tuple:
    """One generation of every island from its ``draws`` (see
    :func:`_draws`): fused fitness, best tracking, the Pareto archive
    merge, elitism, tournament selection, per-op crossover, unit-move,
    collector, redistribution, diag and segment mutations, then the
    freeze of done islands. ``carry`` is the tuple of device tensors
    laid out as the JAX package's (module comment); returns the new
    one. Enqueues only: no host sync."""
    (Px, Py, co, rd, dg, sg,
     aobj, aPx, aPy, aco, ard, adg, asg,
     best_obj, best_vec, bPx, bPy, bco, brd, bdg, bsg,
     flat, steps) = carry
    G, pop, n, X = Px.shape
    Y = Py.shape[3]
    K = aobj.shape[1]
    Q = pop - elite
    done = (flat >= cfg.patience) & (steps > 0)

    # ---------------------------------------------------- fused fitness
    objs = _fitness(cp, cd, float(cfg.seg_overhead), Px, Py, co, rd, dg,
                    sg, batch=int(cfg.batch), options=options,
                    smooth=False)                               # [G, P, 3]
    fit = objs[..., obj_idx]
    order = torch.argsort(fit, dim=1, stable=True)
    gi = order[:, :1]
    gen_best = fit.gather(1, gi)[:, 0]
    improved = gen_best < best_obj * (1.0 - 1e-4)
    better = gen_best < best_obj

    def pick_best(A, old):
        return torch.where(better.reshape((G,) + (1,) * (old.dim() - 1)),
                           _rows(A, gi)[:, 0], old)

    n_best = (torch.where(better, gen_best, best_obj),
              pick_best(objs, best_vec), pick_best(Px, bPx),
              pick_best(Py, bPy), pick_best(co, bco), pick_best(rd, brd),
              pick_best(dg, bdg), pick_best(sg, bsg))

    # ------------------------------------------- Pareto archive merge
    cobj = torch.cat([aobj, objs], 1)                          # [G, K+P, 3]
    keep = _archive_rank(cobj)[:, :K]
    arch = tuple(_rows(torch.cat([a, g], 1), keep)
                 for a, g in ((aobj, objs), (aPx, Px), (aPy, Py),
                              (aco, co), (ard, rd), (adg, dg), (asg, sg)))

    # ---------------------------------------- selection + crossover
    ut, um, uv = draws

    def tourney(u):                       # [Q, k] → winners [G, Q]
        idx = torch.floor(u * pop).long().expand(G, Q, u.shape[-1])
        f = fit.gather(1, idx.reshape(G, -1)).reshape(G, Q, -1)
        return idx.gather(2, torch.argmin(f, dim=2, keepdim=True))[..., 0]

    a = tourney(ut[0])
    b = tourney(ut[1])
    gate = um[0, :, 0] < cfg.p_crossover                      # [Q]
    mask = gate[:, None] & (um[1] < 0.5)                      # [Q, n]
    cPx = torch.where(mask[..., None], _rows(Px, b), _rows(Px, a))
    cPy = torch.where(mask[..., None], _rows(Py, b), _rows(Py, a))
    cco = torch.where(mask, _rows(co, b), _rows(co, a))
    crd = torch.where(mask, _rows(rd, b), _rows(rd, a))
    csg = torch.where(mask, _rows(sg, b), _rows(sg, a))
    cdg = torch.where(gate & (um[7, :, 0] < 0.5), _rows(dg, b), _rows(dg, a))

    # ------------------------------------------------------ mutations
    cPx = _move_units(uv[0:2], cPx, cp["R"], win["lo_x"], win["hi_x"],
                      (um[2] < cfg.p_mutate_partition).expand(G, Q, n))
    cPy = _move_units(uv[2:4], cPy, cp["C"], win["lo_y"], win["hi_y"],
                      (um[3] < cfg.p_mutate_partition).expand(G, Q, n))
    cco = torch.where(um[4] < cfg.p_mutate_collector,
                      torch.floor(um[5] * Y), cco)
    if not cfg.freeze_redist:
        crd = torch.where(um[6] < cfg.p_mutate_redist, 1.0 - crd, crd)
    cdg = torch.where(um[8, :, 0] < cfg.p_mutate_diag, 1.0 - cdg, cdg)
    notlast = torch.cat([torch.ones(n - 1, dtype=_F8, device=Px.device),
                         torch.zeros(1, dtype=_F8, device=Px.device)])
    muts = (um[9] < cfg.p_mutate_seg) & (notlast > 0)
    csg = torch.where(muts, 1.0 - csg, csg) * notlast

    el = order[:, :elite]
    new = ((torch.cat([_rows(Px, el), cPx], 1),
            torch.cat([_rows(Py, el), cPy], 1),
            torch.cat([_rows(co, el), cco], 1),
            torch.cat([_rows(rd, el), crd], 1),
            torch.cat([_rows(dg, el), cdg], 1),
            torch.cat([_rows(sg, el), csg], 1))
           + arch + n_best
           + (torch.where(improved, 0, flat + 1), steps + 1))
    # Freeze done islands: an early-stopped island must report exactly
    # what a solo early-stopped run would.
    return tuple(torch.where(done.reshape((G,) + (1,) * (old.dim() - 1)),
                             old, upd)
                 for old, upd in zip(carry, new))


def _init_carry(pop0, K: int, dev) -> tuple:
    """The carry of generation 0: the population ``pop0`` (six float64
    arrays ``[G, P, ...]``: Px, Py, collectors, redist, diag, seg), an
    empty archive (+inf objectives), no best yet."""
    Px, Py = pop0[0], pop0[1]
    G, _, n, X = Px.shape
    Y = Py.shape[3]

    def z(*shape):
        return torch.zeros(shape, dtype=_F8, device=dev)

    def inf(*shape):
        return torch.full(shape, float("inf"), dtype=_F8, device=dev)

    return (tuple(evaluator_torch.upload(np.asarray(a, dtype=np.float64),
                                         dev) for a in pop0)
            + (inf(G, K, 3), z(G, K, n, X), z(G, K, n, Y), z(G, K, n),
               z(G, K, n), z(G, K), z(G, K, n),
               inf(G), inf(G, 3), z(G, n, X), z(G, n, Y), z(G, n), z(G, n),
               z(G), z(G, n),
               torch.zeros(G, dtype=torch.int64, device=dev),
               torch.zeros(G, dtype=torch.int64, device=dev)))


def _evolve(cp, cd, win, *pop0, cfg: CoSearchConfig, options: EvalOptions,
            obj_idx: int, elite: int, device) -> dict[str, np.ndarray]:
    """Evolve the islands of one device: constant bundles and unit
    windows ``[G, ...]`` and the initial population (six arrays ``[G,
    P, ...]``) → numpy arrays: ``carry`` (the final carry's leaves) and
    ``hist [G, cfg.generations]``, the best objective after each
    generation (NaN past the last one run). The host waits for the
    device once a chunk, for one packed copy."""
    dev = resolve_device(device)
    cp = evaluator_torch.to_device(cp, dev)
    cd = evaluator_torch.to_device(cd, dev)
    win = {k: evaluator_torch.upload(v, dev) for k, v in win.items()}
    carry = _init_carry(pop0, int(cfg.archive_size), dev)
    G, pop, n, _ = carry[0].shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(cfg.seed))

    hist = []
    gens_left = int(cfg.generations)
    chunk_len = max(1, min(int(cfg.patience), gens_left))
    with torch.no_grad():
        while gens_left > 0:
            L = min(chunk_len, gens_left)
            chunk = []
            for _ in range(L):
                draws = _draws(gen, pop - elite, n, int(cfg.tournament), dev)
                carry = _apply(cp, cd, win, carry, draws, cfg=cfg,
                               options=options, obj_idx=obj_idx,
                               elite=elite)
                chunk.append(carry[_BEST_OBJ])
            gens_left -= L
            # One device→host copy per chunk: the chunk's history, the
            # early-stop flag and the whole carry.
            stop = (carry[_FLAT] >= cfg.patience).all()
            packed = torch.cat([torch.stack(chunk, 1).reshape(-1),
                                stop.to(_F8)[None]]
                               + [leaf.to(_F8).reshape(-1)
                                  for leaf in carry])
            host = packed.cpu().numpy()
            hist.append(host[:G * L].reshape(G, L))
            if host[G * L] > 0.5:
                break
    sizes = [leaf.numel() for leaf in carry]
    leaves = np.split(host[G * L + 1:], np.cumsum(sizes)[:-1])
    out = {f"c{i}": a.reshape(tuple(leaf.shape))
           for i, (a, leaf) in enumerate(zip(leaves, carry))}
    ran = np.concatenate(hist, axis=1)                        # [G, T]
    out["hist"] = np.full((G, int(cfg.generations)), np.nan)
    out["hist"][:, :ran.shape[1]] = ran
    return out


# ------------------------------------------------- gradient seeding
def _consts_pair(task: Task, hw: HWConfig, options: EvalOptions):
    """(plain, diagonal) constant bundles + the plain Evaluator. Raises
    if the two meshes diverge outside DIAG_KEYS — the diag gene's
    select/interpolate contract."""
    evp, evd = (Evaluator(task, dataclasses.replace(hw, diagonal_links=d),
                          options, backend="numpy") for d in (False, True))
    cp, cd = evp.consts(), evd.consts()
    for k in cp:
        if k in DIAG_KEYS:
            continue
        if not np.array_equal(np.asarray(cp[k]), np.asarray(cd[k])):
            raise RuntimeError(
                f"diagonal-link mesh changed const {k!r} outside "
                f"DIAG_KEYS — the co-search diag gene cannot select it")
    return cp, cd, evp


def _seed_problem(task: Task, hw: HWConfig, options: EvalOptions,
                  cfg: CoSearchConfig) -> dict:
    """The fixed inputs of the smooth fitness on ``cfg.device``: both
    meshes' constants (``[1, ...]``), the op dims ``M``/``N`` (``[n,
    1]``) and the genes the descent does not move (collectors at
    ``Y // 2``, redistribution where valid, a segment per op)."""
    dev = resolve_device(cfg.device)
    opts = dataclasses.replace(options, congestion="regime")
    cp, cd, evp = _consts_pair(task, hw, opts)
    n, Y = len(task), hw.Y
    up = lambda a: evaluator_torch.upload(  # noqa: E731
        np.asarray(a, dtype=np.float64), dev)
    co = np.full(n, Y // 2, dtype=np.float64)
    rd = (np.asarray(evp.chain_valid, dtype=np.float64)
          if opts.redistribution else np.zeros(n))
    return {
        "options": opts, "device": dev, "co": co,
        "cp": evaluator_torch.to_device({k: v[None] for k, v in cp.items()},
                                        dev),
        "cd": evaluator_torch.to_device(
            {k: cd[k][None] for k in DIAG_KEYS}, dev),
        "M": up(evp.M)[:, None], "N": up(evp.N)[:, None],
        "co_t": up(co), "rd_t": up(rd), "sg_t": up(np.ones(n)),
    }


def _smooth_loss(prob: dict, p: dict, obj_idx: int, cfg: CoSearchConfig
                 ) -> torch.Tensor:
    """The smooth fused objective ``[S]`` of ``S`` relaxed genomes:
    ``p["lx"] [S, n, X]`` and ``p["ly"] [S, n, Y]`` logits (``Px =
    softmax(lx) · M``) and ``p["t"] [S]`` (``diag = sigmoid(t)``).
    Differentiable by ``torch.autograd``."""
    S, n = p["lx"].shape[0], p["lx"].shape[1]
    Px = torch.softmax(p["lx"], dim=-1) * prob["M"]
    Py = torch.softmax(p["ly"], dim=-1) * prob["N"]
    w = torch.sigmoid(p["t"])
    per = lambda v: v.expand(1, S, n)  # noqa: E731
    obj = _fitness(prob["cp"], prob["cd"], float(cfg.seg_overhead),
                   Px[None], Py[None], per(prob["co_t"]), per(prob["rd_t"]),
                   w[None], per(prob["sg_t"]), batch=int(cfg.batch),
                   options=prob["options"], smooth=True)
    return obj[0, :, obj_idx]


def _descend(prob: dict, p0: dict, obj_idx: int, cfg: CoSearchConfig
             ) -> dict:
    """``cfg.seed_steps`` projected-gradient steps from ``p0`` (tensors
    ``lx [S, n, X]``, ``ly [S, n, Y]``, ``t [S]`` on the problem's
    device): each leaf moves by ``seed_lr · g / (max|g| + 1e-30)`` with
    the max taken per start and per leaf, as JAX's per-start ``vmap``
    takes it. The starts' losses are independent, so one backward pass
    of their sum gives every start its own gradient."""
    lr = float(cfg.seed_lr)
    p = {k: v.detach().clone() for k, v in p0.items()}
    names = ("lx", "ly", "t")
    for _ in range(int(cfg.seed_steps)):
        leaves = [p[k].requires_grad_(True) for k in names]
        with torch.enable_grad():
            loss = _smooth_loss(prob, dict(zip(names, leaves)), obj_idx,
                                cfg)
            grads = torch.autograd.grad(loss.sum(), leaves)
        with torch.no_grad():
            for k, x, g in zip(names, leaves, grads):
                m = g.abs().reshape(g.shape[0], -1).amax(-1)
                m = m.reshape((-1,) + (1,) * (g.dim() - 1))
                p[k] = (x - lr * g / (m + 1e-30)).detach()
    return p


def _seed_starts(cfg: CoSearchConfig, n: int, X: int, Y: int, dev) -> dict:
    """The descent's starts, drawn from a ``torch.Generator`` on ``dev``
    seeded by ``cfg.seed``: logits ``N(0, 0.5²)``, ``t ~ N(0, 1)``;
    start 0 is the neutral point (uniform simplex, diag 0.5) — the
    relaxed analogue of the uniform partition."""
    S = int(cfg.seed_starts)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(cfg.seed))

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=_F8, device=dev)

    p0 = {"lx": 0.5 * normal(S, n, X), "ly": 0.5 * normal(S, n, Y),
          "t": normal(S)}
    for v in p0.values():
        v[0] = 0.0
    return p0


def gradient_seeds(task: Task, hw: HWConfig, options: EvalOptions,
                   objective: str, cfg: CoSearchConfig, p0: dict | None = None
                   ) -> list[tuple[Partition, bool]]:
    """Projected-gradient genome proposals (deduplicated), deterministic
    in ``cfg.seed`` on one device: relax the partition lattice to a
    simplex (``softmax(logits) · M``) and the diag gene to a sigmoid,
    descend the smooth fused fitness for ``cfg.seed_steps`` fixed steps
    from ``cfg.seed_starts`` starts (``p0``, or :func:`_seed_starts`),
    then round through :func:`.workload.clamp_partition_to_domain`. The
    smooth objective always runs the regime congestion model — the
    waterfilling netsim has no gradient — which is fine for a *seed*:
    the search itself scores the requested model."""
    if cfg.seed_starts < 1 or cfg.seed_steps < 1:
        return []
    prob = _seed_problem(task, hw, options, cfg)
    n, X, Y = len(task), hw.X, hw.Y
    if p0 is None:
        p0 = _seed_starts(cfg, n, X, Y, prob["device"])
    pT = _descend(prob, p0, OBJECTIVES.index(objective), cfg)
    Pxs = (torch.softmax(pT["lx"], -1) * prob["M"]).cpu().numpy()
    Pys = (torch.softmax(pT["ly"], -1) * prob["N"]).cpu().numpy()
    ws = torch.sigmoid(pT["t"]).cpu().numpy()

    seeds: list[tuple[Partition, bool]] = []
    seen: set = set()
    for s in range(len(ws)):
        part = Partition(np.rint(Pxs[s]).astype(np.int64),
                         np.rint(Pys[s]).astype(np.int64),
                         prob["co"].astype(np.int64))
        part = clamp_partition_to_domain(part, task, X, Y, hw.R, hw.C,
                                         cfg.slack)
        dg = bool(ws[s] > 0.5)
        key = (part.Px.tobytes(), part.Py.tobytes(), dg)
        if key not in seen:
            seen.add(key)
            seeds.append((part, dg))
    return seeds


def miqp_anchor(task: Task, hw: HWConfig, options: EvalOptions,
                objective: str = "edp",
                cfg: CoSearchConfig | None = None) -> Partition:
    """The best projected-gradient proposal, as a lattice anchor for the
    MIQP enumeration (``miqp_lattice.solve_lattice_batch(anchors=)``):
    candidate sets re-order (and, under a cap, prune) around the
    proposal instead of the uniform split. The uniform partition when
    seeding is disabled."""
    cfg = cfg or CoSearchConfig()
    seeds = gradient_seeds(task, hw, options, objective, cfg)
    if not seeds:
        return clamp_partition_to_domain(
            uniform_partition(task, hw.X, hw.Y), task, hw.X, hw.Y,
            hw.R, hw.C, cfg.slack)
    return seeds[0][0]


# --------------------------------------------------------- entry points
def _init_island(task: Task, hw: HWConfig, options: EvalOptions,
                 cfg: CoSearchConfig, seeds):
    """Host population init (seeded by ``cfg.seed`` alone — grid-
    position-independent, the §10 rule): the shared GA init for the
    partition genes plus the co-search genes. Row 0 = uniform partition
    on the plain mesh / one segment; row 1 = uniform on the diagonal
    mesh / per-op segments — elitism floors the search at both
    separate-pass baselines. Gradient seeds fill rows 2.. up to
    ``cfg.seed_fraction``."""
    pop = cfg.population
    n = len(task)
    rng = np.random.default_rng(cfg.seed)
    Px, Py, coll, redist = _random_population_vec(rng, task, hw, cfg, pop)
    dg = (rng.random(pop) < 0.5).astype(np.float64)
    sg = (rng.random((pop, n)) < 0.5).astype(np.float64)
    sg[:, -1] = 0.0
    dg[0], dg[1] = 0.0, 1.0
    sg[0] = 0.0
    sg[1, :-1] = 1.0
    # Row 1 re-uses row 0's uniform partition so both mesh variants
    # start from the separate-pass baselines' LS genome.
    Px[1], Py[1], coll[1], redist[1] = Px[0], Py[0], coll[0], redist[0]
    k = min(len(seeds), int(round(cfg.seed_fraction * pop)), pop - 2)
    for j in range(k):
        part, diag = seeds[j]
        row = 2 + j
        Px[row], Py[row] = part.Px, part.Py
        coll[row] = part.collectors
        dg[row] = float(diag)
        sg[row, :-1], sg[row, -1] = 1.0, 0.0
    return Px, Py, coll, redist, dg, sg


def cosearch_islands(
    tasks: Sequence[Task],
    hws: Sequence[HWConfig],
    options: EvalOptions,
    objective: str,
    cfg: CoSearchConfig,
    devices: str | None = None,
    seeds: Sequence[Sequence[tuple[Partition, bool]]] | None = None,
) -> list[CoSearchResult]:
    """Evolve one joint search per (task, hw) island through one batched
    generation step on ``cfg.device`` (islands must share a shape
    signature — :func:`.sweep.cosearch_sweep` groups). ``hws`` entries
    are normalized to their plain-mesh variant: the diag gene *searches*
    the link axis, so a point's result does not depend on its
    ``diagonal_links`` flag. ``seeds=None`` computes projected-gradient
    proposals per island (``cfg.seed_fraction == 0`` disables); pass
    explicit per-island seed lists (possibly empty) to override — e.g.
    the cold-start arm of a seeding experiment.

    ``devices`` (default ``cfg.devices``) splits the island axis over
    the mesh of :mod:`.sweep_shard` (``grid_mesh(cfg.device)``): each
    shard evolves on its own device with its own generator seeded by
    ``cfg.seed``; results are bitwise the single-device path's."""
    from . import sweep_shard

    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}; "
                         f"one of {OBJECTIVES}")
    G = len(tasks)
    assert G == len(hws) and G > 0
    if seeds is not None and len(seeds) != G:
        raise ValueError(f"seeds must align with islands: "
                         f"{len(seeds)} != {G}")
    devices = cfg.devices if devices is None else devices
    mode = sweep_shard.resolve_devices(devices, G)
    resolve_device(cfg.device)
    pop = cfg.population
    elite = min(cfg.elite, pop - 1)

    hws = [dataclasses.replace(h, diagonal_links=False) for h in hws]
    pairs = [_consts_pair(t, h, options) for t, h in zip(tasks, hws)]
    keys0 = pairs[0][0].keys()
    cp = {k: np.stack([p[0][k] for p in pairs]) for k in keys0}
    cd = {k: np.stack([p[1][k] for p in pairs]) for k in DIAG_KEYS}
    evs = [p[2] for p in pairs]

    win = {"lo_x": [], "hi_x": [], "lo_y": [], "hi_y": []}
    inits = []
    for g, (t, h) in enumerate(zip(tasks, hws)):
        lo, hi = partition_domain(t, h.X, h.Y, h.R, h.C, cfg.slack)
        win["lo_x"].append(lo[:, 0])
        win["hi_x"].append(hi[:, 0])
        win["lo_y"].append(lo[:, 1])
        win["hi_y"].append(hi[:, 1])
        if seeds is not None:
            sd = list(seeds[g])
        elif cfg.seed_fraction > 0:
            sd = gradient_seeds(t, h, options, objective, cfg)
        else:
            sd = []
        inits.append(_init_island(t, h, options, cfg, sd))
    win = {k: np.stack(v).astype(np.float64) for k, v in win.items()}
    pop0 = tuple(np.stack([i[j] for i in inits]).astype(np.float64)
                 for j in range(6))
    evolve = functools.partial(_evolve, cfg=cfg, options=options,
                               obj_idx=OBJECTIVES.index(objective),
                               elite=elite)
    if mode == "sharded":
        out = sweep_shard.sharded_grid_call(
            evolve, (cp, cd, win) + pop0, (True,) * 9, G,
            mesh=sweep_shard.grid_mesh(cfg.device))
    else:
        out = evolve(cp, cd, win, *pop0, device=cfg.device)

    host = [out[f"c{i}"] for i in range(_STEPS + 1)]
    (aobj, aPx, aPy, aco, ard, adg, asg) = host[6:13]
    best_obj, best_vec = host[_BEST_OBJ], host[_BEST_VEC]
    bPx, bPy, bco, brd, bdg, bsg = host[15:21]
    steps = host[_STEPS]
    n = len(tasks[0])

    results = []
    for g in range(G):
        T = int(steps[g])
        part = Partition(np.rint(bPx[g]).astype(np.int64),
                         np.rint(bPy[g]).astype(np.int64),
                         np.rint(bco[g]).astype(np.int64))
        part.validate(tasks[g])
        finite = np.isfinite(aobj[g][:, 0])
        fo = aobj[g][finite]
        mask = pareto_mask(fo)
        order = np.lexsort((fo[mask][:, 2], fo[mask][:, 1],
                            fo[mask][:, 0]))
        sel = np.flatnonzero(finite)[mask][order]
        seg_best = bsg[g] > 0.5
        if n:
            seg_best[-1] = False
        front_seg = asg[g][sel] > 0.5
        if n:
            front_seg[:, -1] = False
        results.append(CoSearchResult(
            partition=part,
            redist_mask=(brd[g] > 0.5) & evs[g].chain_valid,
            diagonal=bool(bdg[g] > 0.5),
            seg_mask=seg_best,
            objective=float(best_obj[g]),
            edp=float(best_vec[g][0]),
            latency=float(best_vec[g][1]),
            energy=float(best_vec[g][2]),
            front={
                "edp": aobj[g][sel][:, 0].copy(),
                "latency": aobj[g][sel][:, 1].copy(),
                "energy": aobj[g][sel][:, 2].copy(),
                "Px": aPx[g][sel].copy(),
                "Py": aPy[g][sel].copy(),
                "collectors": aco[g][sel].copy(),
                "redist": ard[g][sel] > 0.5,
                "diag": adg[g][sel] > 0.5,
                "seg": front_seg,
            },
            history=out["hist"][g, :T].copy(),
            evaluations=T * pop,
        ))
    return results


def run_cosearch(task: Task, hw: HWConfig, objective: str = "edp",
                 options: EvalOptions | None = None,
                 cfg: CoSearchConfig | None = None) -> CoSearchResult:
    """Single-point entry: the ``G = 1`` case of :func:`cosearch_islands`
    (the same step, so the result matches the island path exactly)."""
    return cosearch_islands([task], [hw], options or EvalOptions(),
                            objective, cfg or CoSearchConfig())[0]
