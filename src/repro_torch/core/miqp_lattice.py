"""Batched MIQP engine — exact lattice enumeration (DESIGN.md §12),
scored on the card.

The port's counterpart of the JAX package's ``core/miqp_jax.py``: the
same enumeration, modes and descent, with the scoring chunks going to
the float64 torch evaluator (:mod:`.evaluator_torch`) where the JAX
package sends them to its jitted one. Arg-mins, beam orders and moves
stay on the host in numpy, as there.

The MILP path (:mod:`.miqp`) hands the Sec. 6.3 program to
HiGHS one instance at a time under a wall-clock budget, and approximates
the EDP product objective with an ε-constraint sweep. This module takes
the observation in that module's docstring to its conclusion: on the
paper's constrained search space (partitions are multiples of R within
±``slack`` units of uniform, Sec. 6.2) every integer variable has a
small one-hot domain — the feasible set is a finite *lattice* — so
instead of relaxing products into binary McCormick envelopes we
materialize candidate schedules as genome tensors and arg-min the
**exact** evaluator over them:

  * **Per-layer choice lattices** — for every op, the unit compositions
    of the padded row/column sums inside the Sec.-6.2 window, enumerated
    nearest-uniform-first (ordered by L1 deviation from the in-window
    anchor, lexicographic within a deviation level) and capped per
    axis/layer; an op's candidate set is the (rows × cols) product,
    ordered by combined deviation. Candidate 0 is always the anchor —
    the in-window projection of the LS-uniform split.
  * **Exact mode** — when the joint cross-product over ops fits
    ``cfg.candidate_budget``, every joint assignment is scored and the
    arg-min is the lattice optimum (exhaustive over the enumerated
    sets; globally exact whenever no cap bound).
  * **Beam mode** — otherwise a deterministic beam of
    ``cfg.beam_width`` assignments is extended layer by layer over the
    full per-layer sets (capturing the forward redistribution coupling
    between consecutive ops), then width-1 refinement sweeps re-scan
    every layer against the final assignment until a fixpoint or
    ``cfg.refine_sweeps``. Per-layer caps derive from
    ``cfg.eval_budget`` — a *deterministic* budget in scored genomes,
    not wall-clock, so a point's result is identical whether it is
    solved alone or batched in a sweep group (the §9 cache invariant;
    the GA gets the same property from seed-only RNG).
  * **Unit-move descent** — both modes finish with sum-preserving
    single-unit moves (the GA's mutation move, searched exhaustively):
    every (op, donor, receiver) R/C-unit transfer that stays inside the
    Sec.-6.2 window is scored at once, the best improving move per op
    is applied (joint application verified against a single-move
    fallback, so the objective is monotone), until a fixpoint or
    ``cfg.descent_sweeps``. This escapes the candidate caps — large
    grids win coordinated high-deviation patterns the nearest-uniform
    sets cannot reach — and is a no-op when the enumerated sets were
    complete (an exact-mode optimum is already unit-move optimal).
  * **Chunked scoring** — candidates are scored through the torch
    evaluator in fixed-shape chunks (grid axis = same-shape points,
    population axis = candidate chunk, bucketed to powers of two ≤
    ``cfg.score_chunk`` and padded with candidate 0, masked on the
    host); the constants go to the device once per group. The numpy
    backend scores identical chunks through the reference evaluator and
    is the parity engine. EDP is an output key of the evaluator, so the
    product objective is scored directly — no ε-constraint sweep.

Like the MILP, the lattice fixes the non-partition genome dimensions the
way Sec. 6.3 does — collector column ``Y//2``, redistribution on every
semantically valid chained pair — and leaves them to ``api._polish``.

``solve_lattice_batch.score_calls`` counts the scoring calls (one per
chunk, any backend), as the kernels' wrappers count their launches.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .evaluator import EvalOptions, Evaluator, resolve_auto_backend
from .hw import HWConfig
from .miqp import DEVICE_MODES, MIQPConfig, MIQPResult, _unpad_rows
from .workload import Partition, Task, partition_domain

__all__ = ["OBJECTIVES", "axis_lattice", "layer_lattice",
           "solve_lattice_batch"]

#: Objective keys the lattice can minimize (evaluator outputs; the MILP
#: engine supports only latency/edp, and edp only via its ε-sweep).
OBJECTIVES = ("latency", "energy", "edp")

_MIN_CHUNK = 64


# ------------------------------------------------------------ enumeration
def _axis_anchor(S: int, parts: int, lo: int, hi: int) -> np.ndarray:
    """The in-window projection of the uniform split: ``parts`` unit
    counts in ``[lo, hi]`` summing to ``S``, as even as possible."""
    if not lo * parts <= S <= hi * parts:
        raise ValueError(f"infeasible axis window: {parts}x[{lo},{hi}] "
                         f"cannot sum to {S}")
    base, rem = divmod(S, parts)
    a = np.clip(np.full(parts, base, dtype=np.int64), lo, hi)
    a[:rem] = np.clip(a[:rem] + 1, lo, hi)
    resid = int(S - a.sum())
    while resid != 0:
        step = 1 if resid > 0 else -1
        for k in range(parts):
            if resid == 0:
                break
            if lo <= a[k] + step <= hi:
                a[k] += step
                resid -= step
    return a


def _repair_units(units: np.ndarray, S: int, lo: int, hi: int
                  ) -> np.ndarray:
    """Project an arbitrary unit vector into the axis window: clip to
    ``[lo, hi]``, then walk the residue one unit at a time (the same
    repair loop as :func:`_axis_anchor`). Turns external anchor
    proposals (the co-search's gradient seeds, DESIGN.md §16) into
    valid lattice anchors."""
    parts = len(units)
    if not lo * parts <= S <= hi * parts:
        raise ValueError(f"infeasible axis window: {parts}x[{lo},{hi}] "
                         f"cannot sum to {S}")
    a = np.clip(np.asarray(units, dtype=np.int64), lo, hi)
    resid = int(S - a.sum())
    while resid != 0:
        step = 1 if resid > 0 else -1
        for k in range(parts):
            if resid == 0:
                break
            if lo <= a[k] + step <= hi:
                a[k] += step
                resid -= step
    return a


def _monotone_axis(S: int, parts: int, lo: int, hi: int, cap: int
                   ) -> tuple[list[tuple[int, ...]], bool]:
    """All non-decreasing unit compositions of ``S`` into ``parts``
    entries within ``[lo, hi]`` (the window is entry-independent, so
    monotone value vectors are placement families)."""
    out: list[tuple[int, ...]] = []
    v = [0] * parts

    def rec(k: int, prev: int, rem: int) -> bool:
        left = parts - k
        if k == parts:
            if rem == 0:
                out.append(tuple(v))
                return len(out) < cap
            return True
        lo_k = max(lo, prev, rem - hi * (left - 1))
        hi_k = min(hi, rem - lo * (left - 1))
        for val in range(lo_k, hi_k + 1):
            v[k] = val
            if not rec(k + 1, val, rem - val):
                return False
        return True

    complete = rec(0, lo, S)
    return out, complete


def axis_lattice(S: int, parts: int, lo: int, hi: int, cap: int,
                 anchor: np.ndarray | None = None,
                 ) -> tuple[np.ndarray, np.ndarray, bool]:
    """Enumerate unit compositions of ``S`` into ``parts`` entries within
    ``[lo, hi]``, structured-candidates-first.

    The list opens with the **ridge family** — every monotone
    composition, emitted in both placements (non-increasing, then
    non-decreasing), ordered by L1 deviation from the in-window uniform
    anchor. Monotone-by-position patterns are what the serialization
    maxima of eqs. 8–12 reward (trade compute balance against
    entrance-distance-weighted delivery), and they reach arbitrarily
    high deviation at tiny candidate cost, where exhaustive
    nearest-uniform enumeration drowns. The remaining slots fill with
    the general enumeration ordered by L1 deviation (lexicographic in
    deviation space within a level), deduplicated — so candidate 0 is
    always the anchor and small caps keep global structure *and* the
    near-uniform neighbourhood.

    Returns ``(units [C, parts], l1 [C], complete)``; ``complete`` means
    the *general* enumeration finished before hitting ``cap`` (the set
    is the full window lattice).

    ``anchor`` (optional) recenters the enumeration on an external unit
    vector instead of the in-window uniform projection — deviation
    ordering, ridge ranking and the dfs budget levels all measure L1
    distance from it, so a capped lattice keeps the *anchor's*
    neighbourhood (how the co-search's gradient seeds prune the MIQP
    enumeration, DESIGN.md §16). The anchor is window-repaired and
    emitted as candidate 0; ``anchor=None`` keeps the uniform-anchor
    lattice bit for bit.
    """
    if anchor is None:
        a = _axis_anchor(S, parts, lo, hi)
    else:
        a = _repair_units(anchor, S, lo, hi)
    seen: set[tuple[int, ...]] = set()
    out: list[tuple[int, ...]] = []

    def push(vec) -> bool:
        t = tuple(int(x) for x in vec)
        if t not in seen:
            seen.add(t)
            out.append(t)
        return len(out) < cap

    if anchor is not None:
        # A custom anchor need not be monotone — emit it explicitly so
        # candidate 0 is the anchor under any cap.
        push(a)
    ridge, ridge_complete = _monotone_axis(S, parts, lo, hi, cap)
    ridge = sorted(ridge, key=lambda t: (int(np.abs(np.array(t) - a).sum()),
                                         t))
    capped = False
    for t in ridge:
        if not (push(t[::-1]) and push(t)):
            capped = True
            break

    dlo = (lo - a).astype(int)
    dhi = (hi - a).astype(int)
    # Suffix feasibility bounds for pruning: achievable remaining sum and
    # remaining L1 capacity from position k onward.
    smin = np.concatenate([np.cumsum(dlo[::-1])[::-1], [0]])
    smax = np.concatenate([np.cumsum(dhi[::-1])[::-1], [0]])
    capl1 = np.concatenate(
        [np.cumsum(np.maximum(np.abs(dlo), np.abs(dhi))[::-1])[::-1], [0]])
    d = [0] * parts

    def dfs(k: int, cur_sum: int, rem_l1: int) -> bool:
        """Emit deviation vectors spending exactly ``rem_l1`` more L1;
        returns False once the cap is hit."""
        if k == parts:
            if cur_sum == 0 and rem_l1 == 0:
                return push(np.asarray(d) + a)
            return True
        need = -cur_sum
        if not (smin[k] <= need <= smax[k]):
            return True
        if abs(need) > rem_l1 or rem_l1 > capl1[k] \
                or (rem_l1 - abs(need)) % 2:
            return True
        for v in range(max(dlo[k], -rem_l1), min(dhi[k], rem_l1) + 1):
            d[k] = v
            if not dfs(k + 1, cur_sum + v, rem_l1 - abs(v)):
                d[k] = 0
                return False
            d[k] = 0
        return True

    complete = ridge_complete and not capped
    if not capped:
        for budget in range(0, int(capl1[0]) + 1, 2):
            if not dfs(0, 0, budget):
                complete = False
                break
    units = np.asarray(out, dtype=np.int64).reshape(len(out), parts)
    return units, np.abs(units - a).sum(axis=1), complete


def layer_lattice(task: Task, hw: HWConfig, cfg: MIQPConfig,
                  anchor: Partition | None = None) -> list[dict]:
    """Per-op candidate sets, ordered by combined row+column deviation
    from uniform. Each entry holds the R/C *unit* vectors (``ux [C, X]``,
    ``uy [C, Y]``, the descent phase moves in this space), the un-padded
    exact-sum partition values (``px``, ``py`` — what the evaluator
    scores), and a ``complete`` flag (no cap bound).

    ``anchor`` (optional :class:`Partition`) recenters each op's axis
    lattices on the anchor's rows instead of the uniform projection —
    value-space rows convert back to units via ``ceil(p / unit)``, the
    inverse of the ``unpad(u·unit)`` emission."""
    X, Y = hw.X, hw.Y
    lo, hi = partition_domain(task, X, Y, hw.R, hw.C, cfg.slack)
    out = []
    for i, op in enumerate(task.ops):
        Mu = int(np.ceil(op.M / hw.R))
        Nu = int(np.ceil(op.N / hw.C))
        ax = ay = None
        if anchor is not None:
            ax = np.ceil(anchor.Px[i] / hw.R).astype(np.int64)
            ay = np.ceil(anchor.Py[i] / hw.C).astype(np.int64)
        ux, l1x, cx = axis_lattice(Mu, X, int(lo[i, 0]), int(hi[i, 0]),
                                   cfg.max_axis_candidates, anchor=ax)
        uy, l1y, cy = axis_lattice(Nu, Y, int(lo[i, 1]), int(hi[i, 1]),
                                   cfg.max_axis_candidates, anchor=ay)
        # (rows × cols) pairs by combined axis *rank* (not raw L1 — the
        # axis lists lead with the ridge family, and rank order is what
        # keeps it alive under the layer cap); the stable argsort of the
        # row-major ravel keeps (jx, jy)-lex order within a level.
        comb = (np.arange(len(l1x))[:, None]
                + np.arange(len(l1y))[None, :]).ravel()
        order = np.argsort(comb, kind="stable")[:cfg.max_layer_candidates]
        jx, jy = order // len(l1y), order % len(l1y)
        out.append({
            "ux": ux[jx], "uy": uy[jy],
            "px": _unpad_rows(ux[jx] * hw.R, op.M),
            "py": _unpad_rows(uy[jy] * hw.C, op.N),
            "complete": (cx and cy
                         and comb.size <= cfg.max_layer_candidates),
        })
    return out


class _Space:
    """One point's enumerated search lattice + its Sec.-6.2 windows."""

    def __init__(self, task: Task, hw: HWConfig, cfg: MIQPConfig,
                 anchor: Partition | None = None):
        self.task = task
        self.hw = hw
        lo, hi = partition_domain(task, hw.X, hw.Y, hw.R, hw.C, cfg.slack)
        self.lo, self.hi = lo, hi
        self.cands = layer_lattice(task, hw, cfg, anchor=anchor)
        self.sizes = [len(c["px"]) for c in self.cands]
        self.joint = int(np.prod(self.sizes, dtype=object))
        self.complete = all(c["complete"] for c in self.cands)

    def recap(self, cap: int) -> None:
        """Beam mode: shrink every layer to its budget-derived cap. The
        sets are deviation-ordered, so slicing keeps the nearest-uniform
        candidates (and candidate 0 stays the anchor)."""
        for c in self.cands:
            c["complete"] = c["complete"] and len(c["px"]) <= cap
            for k in ("ux", "uy", "px", "py"):
                c[k] = c[k][:cap]
        self.sizes = [len(c["px"]) for c in self.cands]

    def genome(self, assign: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """``assign [P, n]`` candidate indices → ``(Px [P, n, X],
        Py [P, n, Y])`` float64 genome tensors.

        Indices are clipped to each layer's candidate count: lockstep
        group phases extend up to the group-wide max per layer, and a
        smaller point's out-of-range columns are placeholders whose
        scores the caller masks to +inf before any selection — they
        only need to score *something* without faulting."""
        Px = np.stack([
            self.cands[i]["px"][np.minimum(assign[:, i],
                                           self.sizes[i] - 1)]
            for i in range(assign.shape[1])], axis=1)
        Py = np.stack([
            self.cands[i]["py"][np.minimum(assign[:, i],
                                           self.sizes[i] - 1)]
            for i in range(assign.shape[1])], axis=1)
        return Px.astype(np.float64), Py.astype(np.float64)

    def units(self, assign: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """``assign [n]`` → unit-count vectors ``(ux [n, X], uy [n, Y])``
        — the descent phase's working representation."""
        ux = np.stack([self.cands[i]["ux"][assign[i]]
                       for i in range(len(assign))])
        uy = np.stack([self.cands[i]["uy"][assign[i]]
                       for i in range(len(assign))])
        return ux, uy

    def unpad(self, Ux: np.ndarray, Uy: np.ndarray
              ) -> tuple[np.ndarray, np.ndarray]:
        """Unit tensors ``[P, n, X/Y]`` → exact-sum genome tensors."""
        Px = np.empty(Ux.shape, dtype=np.float64)
        Py = np.empty(Uy.shape, dtype=np.float64)
        for i, op in enumerate(self.task.ops):
            Px[:, i] = _unpad_rows(Ux[:, i] * self.hw.R, op.M)
            Py[:, i] = _unpad_rows(Uy[:, i] * self.hw.C, op.N)
        return Px, Py


# --------------------------------------------------------------- scoring
def _bucket(p: int, chunk: int) -> int:
    b = _MIN_CHUNK
    while b < min(p, chunk):
        b *= 2
    return b


class _GroupScorer:
    """Chunked exact scoring for one group of same-shape points (grid
    axis = points, population axis = candidate chunk; chunk shapes are
    bucketed to powers of two)."""

    def __init__(self, tasks, hws, spaces, options: EvalOptions,
                 objective: str, backend: str, chunk: int, device=None,
                 devices: str = "single"):
        self.spaces = spaces
        self.options = options
        self.objective = objective
        self.backend = backend
        self.chunk = chunk
        self.device = device
        self.devices = devices
        self.evals = 0
        self.evs = [Evaluator(t, h, options, backend="numpy")
                    for t, h in zip(tasks, hws)]
        n = len(tasks[0])
        self.co = np.stack([np.full(n, h.Y // 2, dtype=np.float64)
                            for h in hws])
        self.rd = np.stack([
            (ev.chain_valid & options.redistribution).astype(np.float64)
            for ev in self.evs])
        if backend == "torch":
            from . import evaluator_torch

            consts = [ev.consts() for ev in self.evs]
            self._stacked = evaluator_torch.to_device(
                {k: np.stack([c[k] for c in consts]) for k in consts[0]},
                device)

    def _score_genomes(self, Px: np.ndarray, Py: np.ndarray) -> np.ndarray:
        """``Px [G, P, n, X]``, ``Py [G, P, n, Y]`` → ``[G, P]``. P must
        already be a bucket size (callers pad)."""
        G, P = Px.shape[:2]
        co = np.broadcast_to(self.co[:, None], (G, P, self.co.shape[1]))
        rd = np.broadcast_to(self.rd[:, None], (G, P, self.rd.shape[1]))
        solve_lattice_batch.score_calls += 1
        if self.backend == "torch":
            from . import evaluator_torch

            vals = evaluator_torch.grid_evaluate(
                self._stacked, self.options, Px, Py, co, rd, self.device,
                devices=self.devices)[self.objective]
        else:
            vals = np.stack([
                self.evs[g].evaluate_batch(Px[g], Py[g], co[g],
                                           rd[g])[self.objective]
                for g in range(G)])
        self.evals += G * P
        return np.asarray(vals)

    def _chunked(self, P: int, make_genomes) -> np.ndarray:
        """Drive ``make_genomes(s, e, pad)`` → (Px, Py) chunk factories
        through bucketed scoring calls; returns ``[G, P]``."""
        G = len(self.spaces)
        out = np.empty((G, P), dtype=np.float64)
        s = 0
        while s < P:
            e = min(s + self.chunk, P)
            b = _bucket(e - s, self.chunk)
            Px, Py = make_genomes(s, e, b - (e - s))
            out[:, s:e] = self._score_genomes(Px, Py)[:, : e - s]
            s = e
        return out

    def score(self, assign: np.ndarray) -> np.ndarray:
        """``assign [G, P, n]`` candidate indices → objectives ``[G, P]``
        float64. Pad columns (candidate 0) never reach an arg-min —
        callers mask by per-point length."""
        G, P, n = assign.shape

        def make(s, e, pad):
            blk = assign[:, s:e]
            if pad:
                blk = np.concatenate(
                    [blk, np.zeros((G, pad, n), dtype=assign.dtype)],
                    axis=1)
            Px = np.stack([sp.genome(blk[g])[0]
                           for g, sp in enumerate(self.spaces)])
            Py = np.stack([sp.genome(blk[g])[1]
                           for g, sp in enumerate(self.spaces)])
            return Px, Py

        return self._chunked(P, make)

    def score_units(self, Ux: np.ndarray, Uy: np.ndarray) -> np.ndarray:
        """``Ux [G, P, n, X]``, ``Uy [G, P, n, Y]`` unit tensors →
        objectives ``[G, P]`` (descent phase)."""
        G, P = Ux.shape[:2]

        def make(s, e, pad):
            bx, by = Ux[:, s:e], Uy[:, s:e]
            if pad:
                bx = np.concatenate([bx, bx[:, :1].repeat(pad, 1)], axis=1)
                by = np.concatenate([by, by[:, :1].repeat(pad, 1)], axis=1)
            Px = np.empty(bx.shape, dtype=np.float64)
            Py = np.empty(by.shape, dtype=np.float64)
            for g, sp in enumerate(self.spaces):
                Px[g], Py[g] = sp.unpad(bx[g], by[g])
            return Px, Py

        return self._chunked(P, make)


# ----------------------------------------------------------------- modes
def _solve_exact(spaces: Sequence[_Space], scorer: _GroupScorer
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Score every joint assignment (mixed-radix over the per-layer
    sets); returns per-point (best assignment [G, n], best objective)."""
    G = len(spaces)
    n = len(spaces[0].sizes)
    chunk = scorer.chunk
    T = np.array([sp.joint for sp in spaces], dtype=np.int64)
    strides = []
    for sp in spaces:
        st = np.ones(n, dtype=np.int64)
        for i in range(n - 2, -1, -1):
            st[i] = st[i + 1] * sp.sizes[i + 1]
        strides.append(st)
    best = np.full(G, np.inf)
    best_a = np.zeros((G, n), dtype=np.int64)
    for s in range(0, int(T.max()), chunk):
        width = min(chunk, int(T.max()) - s)
        ids = np.arange(s, s + width, dtype=np.int64)
        assign = np.zeros((G, width, n), dtype=np.int64)
        for g, sp in enumerate(spaces):
            t = np.minimum(ids, T[g] - 1)
            assign[g] = (t[:, None] // strides[g][None]) \
                % np.asarray(sp.sizes, dtype=np.int64)[None]
        sc = scorer.score(assign)
        sc[ids[None, :] >= T[:, None]] = np.inf
        j = np.argmin(sc, axis=1)
        for g in range(G):
            if sc[g, j[g]] < best[g]:
                best[g] = sc[g, j[g]]
                best_a[g] = assign[g, j[g]]
    return best_a, best


def _solve_beam(spaces: Sequence[_Space], scorer: _GroupScorer,
                cfg: MIQPConfig) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic beam over layers + width-1 refinement sweeps.
    Returns (best assignment [G, n], best objective [G])."""
    G = len(spaces)
    n = len(spaces[0].sizes)
    W = max(1, cfg.beam_width)
    sizes = np.array([sp.sizes for sp in spaces])          # [G, n]
    beam = np.zeros((G, W, n), dtype=np.int64)
    bsc = np.full((G, W), np.inf)
    bsc[:, :1] = scorer.score(beam[:, :1, :])
    for i in range(n):
        Cmax = int(sizes[:, i].max())
        ext = np.repeat(beam, Cmax, axis=1)                # [G, W·Cmax, n]
        cand = np.tile(np.arange(Cmax), W)
        ext[:, :, i] = cand[None, :]
        sc = scorer.score(ext)
        invalid = (cand[None, :] >= sizes[:, i][:, None]) \
            | np.repeat(~np.isfinite(bsc), Cmax, axis=1)
        sc[invalid] = np.inf
        order = np.argsort(sc, axis=1, kind="stable")[:, :W]
        for g in range(G):
            beam[g] = ext[g, order[g]]
            bsc[g] = sc[g, order[g]]
    best_a, best = beam[:, 0].copy(), bsc[:, 0].copy()
    for _ in range(max(0, cfg.refine_sweeps)):
        improved = False
        for i in range(n):
            Cmax = int(sizes[:, i].max())
            ext = np.repeat(best_a[:, None, :], Cmax, axis=1)
            ext[:, :, i] = np.arange(Cmax)[None, :]
            sc = scorer.score(ext)
            sc[np.arange(Cmax)[None, :] >= sizes[:, i][:, None]] = np.inf
            j = np.argmin(sc, axis=1)
            for g in range(G):
                if sc[g, j[g]] < best[g]:
                    best[g] = sc[g, j[g]]
                    best_a[g] = ext[g, j[g]]
                    improved = True
        if not improved:
            break
    return best_a, best


def _pair_refine(spaces: Sequence[_Space], scorer: _GroupScorer,
                 best_a: np.ndarray, best: np.ndarray,
                 cfg: MIQPConfig) -> tuple[np.ndarray, np.ndarray]:
    """Joint re-scan of chained layer pairs: for every (i, i+1) with a
    semantically valid chain (the pairs coupled through the Sec.-5.2
    crossing term and the keep-A input mask), score the top-k × top-k
    product of both layers' candidate sets against the current
    assignment and keep strict improvements. Width-1 refinement cannot
    cross these plateaus — the per-op terms of two tied placements are
    equal and only their *joint* alignment moves the crossing max. k is
    derived deterministically from ``cfg.eval_budget`` (≤ a quarter of
    it across all pairs) and capped at ``cfg.pair_refine``."""
    if cfg.pair_refine < 2:
        return best_a, best
    G = len(spaces)
    n = len(spaces[0].sizes)
    chains = [np.where(scorer.evs[g].chain_valid)[0] for g in range(G)]
    pairs = sorted({int(i) for cv in chains for i in cv if i + 1 < n})
    if not pairs:
        return best_a, best
    # k is a *per-point* function of that point's own chain count — a
    # point's result must not depend on which group solved it (§9 cache
    # invariant); the lockstep loop runs over the union of pairs and
    # masks each point to its own k.
    kg = np.array([
        min(cfg.pair_refine,
            max(2, int(np.sqrt(cfg.eval_budget
                               // max(1, 4 * len(chains[g]))))))
        for g in range(G)])
    sizes = np.array([sp.sizes for sp in spaces])          # [G, n]
    for i in pairs:
        ka = int(np.minimum(kg, sizes[:, i]).max())
        kb = int(np.minimum(kg, sizes[:, i + 1]).max())
        ext = np.repeat(best_a[:, None, :], ka * kb, axis=1)
        a_idx = np.repeat(np.arange(ka), kb)
        b_idx = np.tile(np.arange(kb), ka)
        ext[:, :, i] = a_idx[None, :]
        ext[:, :, i + 1] = b_idx[None, :]
        sc = scorer.score(ext)
        lim_a = np.minimum(kg, sizes[:, i])[:, None]
        lim_b = np.minimum(kg, sizes[:, i + 1])[:, None]
        invalid = (a_idx[None, :] >= lim_a) \
            | (b_idx[None, :] >= lim_b) \
            | ~np.array([i in chains[g] for g in range(G)])[:, None]
        sc[invalid] = np.inf
        j = np.argmin(sc, axis=1)
        for g in range(G):
            if sc[g, j[g]] < best[g]:
                best[g] = sc[g, j[g]]
                best_a[g] = ext[g, j[g]]
    return best_a, best


def _unit_descent(spaces: Sequence[_Space], scorer: _GroupScorer,
                  Ux: np.ndarray, Uy: np.ndarray, cur: np.ndarray,
                  cfg: MIQPConfig) -> tuple[np.ndarray, np.ndarray,
                                            np.ndarray, np.ndarray]:
    """Exhaustive sum-preserving local search from the beam/exact
    solution (``Ux [G, n, X]``, ``Uy [G, n, Y]`` unit counts, ``cur
    [G]`` their objectives). Every sweep scores two deterministic move
    families at once — single-unit (op, donor, receiver) transfers (the
    GA's mutation move) and entry *transpositions* (swap two shares of
    one op's axis, which crosses the placement plateaus that
    single-unit paths cannot: permuting a share vector changes the
    Sec.-5.2 crossing terms against its chained neighbours while
    keeping every per-entry window constraint), and *range swaps* —
    the same row transposition applied to a whole chained span of ops
    at once (chained neighbours with aligned placements must move
    together or the crossing max punishes every intermediate step) —
    applies the best improving move per op jointly (verified, falling
    back to the single best move if the joint step is not an
    improvement; range swaps participate keyed by their first op), and
    stops at a fixpoint or ``cfg.descent_sweeps``. Deterministic,
    strictly monotone. Returns updated units, objectives, and
    per-point accepted-move counts."""
    G, n, X = Ux.shape
    Y = Uy.shape[2]
    mv_x = [(i, d, r) for i in range(n) for d in range(X)
            for r in range(X) if d != r]
    mv_y = [(i, d, r) for i in range(n) for d in range(Y)
            for r in range(Y) if d != r]
    sw_x = [(i, d, r) for i in range(n) for d in range(X)
            for r in range(d + 1, X)]
    sw_y = [(i, d, r) for i in range(n) for d in range(Y)
            for r in range(d + 1, Y)]
    # Chained range swaps: spans [a, b] whose interior pairs are all
    # chain-valid on at least one point (per-point validity masked
    # below), capped at length 8 — the Sec.-5.2 coupling radius worth
    # paying for.
    chain_any = np.zeros(n, dtype=bool)
    for sp in spaces:
        cv = np.zeros(n, dtype=bool)
        for i in range(n - 1):
            cv[i] = bool(sp.task.ops[i + 1].chained)
        chain_any |= cv
    rg_x = [(a, b, d, r)
            for a in range(n) for b in range(a + 1, min(n, a + 8))
            if chain_any[a:b].all()
            for d in range(X) for r in range(d + 1, X)]
    P = len(mv_x) + len(mv_y) + len(sw_x) + len(sw_y) + len(rg_x)
    moves = np.zeros(G, dtype=np.int64)
    if P == 0:
        return Ux, Uy, cur, moves
    ix, dx, rx = (np.array([m[k] for m in mv_x], dtype=np.int64)
                  for k in range(3))
    iy, dy, ry = (np.array([m[k] for m in mv_y], dtype=np.int64)
                  for k in range(3))
    sxi, sxd, sxr = (np.array([m[k] for m in sw_x], dtype=np.int64)
                     for k in range(3))
    syi, syd, syr = (np.array([m[k] for m in sw_y], dtype=np.int64)
                     for k in range(3))
    # Range swaps are excluded from the per-op joint step (they span
    # several ops); they compete through the single-best-move path,
    # which copies the full proposal.
    op_of = np.concatenate([ix, iy, sxi, syi,
                            np.full(len(rg_x), -1, dtype=np.int64)])
    lo_x = np.stack([sp.lo[:, 0] for sp in spaces])        # [G, n]
    hi_x = np.stack([sp.hi[:, 0] for sp in spaces])
    lo_y = np.stack([sp.lo[:, 1] for sp in spaces])
    hi_y = np.stack([sp.hi[:, 1] for sp in spaces])
    rg_chain = np.array([[all(sp.task.ops[i + 1].chained
                              for i in range(a, b))
                          for (a, b, d, r) in rg_x]
                         for sp in spaces]).reshape(G, len(rg_x))
    for _ in range(max(0, cfg.descent_sweeps)):
        pUx = np.repeat(Ux[:, None], P, axis=1)            # [G, P, n, X]
        pUy = np.repeat(Uy[:, None], P, axis=1)
        ax = np.arange(len(mv_x))
        pUx[:, ax, ix, dx] -= 1
        pUx[:, ax, ix, rx] += 1
        ay = len(mv_x) + np.arange(len(mv_y))
        pUy[:, ay, iy, dy] -= 1
        pUy[:, ay, iy, ry] += 1
        asx = len(mv_x) + len(mv_y) + np.arange(len(sw_x))
        pUx[:, asx, sxi, sxd] = Ux[:, sxi, sxr]
        pUx[:, asx, sxi, sxr] = Ux[:, sxi, sxd]
        asy = len(mv_x) + len(mv_y) + len(sw_x) + np.arange(len(sw_y))
        pUy[:, asy, syi, syd] = Uy[:, syi, syr]
        pUy[:, asy, syi, syr] = Uy[:, syi, syd]
        rg_valid = np.zeros((G, len(rg_x)), dtype=bool)
        arg = len(mv_x) + len(mv_y) + len(sw_x) + len(sw_y)
        for q, (a, b, d, r) in enumerate(rg_x):
            span = slice(a, b + 1)
            pUx[:, arg + q, span, d] = Ux[:, span, r]
            pUx[:, arg + q, span, r] = Ux[:, span, d]
            rg_valid[:, q] = rg_chain[:, q] & (Ux[:, span, d]
                                               != Ux[:, span, r]).any(axis=1)
        valid = np.concatenate([
            (Ux[:, ix, dx] - 1 >= lo_x[:, ix])
            & (Ux[:, ix, rx] + 1 <= hi_x[:, ix]),
            (Uy[:, iy, dy] - 1 >= lo_y[:, iy])
            & (Uy[:, iy, ry] + 1 <= hi_y[:, iy]),
            Ux[:, sxi, sxd] != Ux[:, sxi, sxr],   # swaps: window-free,
            Uy[:, syi, syd] != Uy[:, syi, syr],   # no-ops masked out
            rg_valid,
        ], axis=1)                                         # [G, P]
        sc = scorer.score_units(pUx, pUy)
        sc[~valid] = np.inf
        improving = sc < cur[:, None]
        if not improving.any():
            break
        # Joint candidate: best improving move per op, all applied.
        jUx, jUy = Ux.copy(), Uy.copy()
        n_chosen = np.zeros(G, dtype=np.int64)
        for g in range(G):
            for i in range(n):
                mask = improving[g] & (op_of == i)
                if not mask.any():
                    continue
                j = int(np.argmin(np.where(mask, sc[g], np.inf)))
                jUx[g, i] = pUx[g, j, i]
                jUy[g, i] = pUy[g, j, i]
                n_chosen[g] += 1
        ver = scorer.score_units(jUx[:, None], jUy[:, None])[:, 0]
        for g in range(G):
            if not improving[g].any():
                continue
            j = int(np.argmin(sc[g]))
            if n_chosen[g] > 1 and ver[g] < min(cur[g], sc[g, j]):
                Ux[g], Uy[g], cur[g] = jUx[g], jUy[g], ver[g]
                moves[g] += n_chosen[g]
            else:
                Ux[g], Uy[g], cur[g] = pUx[g, j], pUy[g, j], sc[g, j]
                moves[g] += 1
    return Ux, Uy, cur, moves


# ------------------------------------------------------------ entry point
def solve_lattice_batch(
    tasks: Sequence[Task],
    hws: Sequence[HWConfig],
    options: EvalOptions,
    objective: str,
    cfg: MIQPConfig,
    anchors: Sequence[Partition | None] | None = None,
) -> list[MIQPResult]:
    """Solve one MIQP lattice search per (task, hw) point through batched
    scoring calls. All points must share a shape signature (n_ops, X, Y,
    n_entrances); a solo :func:`.miqp.run_miqp` call is the ``G=1`` case
    of the same deterministic program, so results are identical either
    way. Returns one :class:`.miqp.MIQPResult` per point, aligned with
    the inputs.

    ``anchors`` (optional, per point, entries may be ``None``) recenters
    each point's lattice enumeration on an external :class:`Partition`
    proposal (see :func:`layer_lattice`; e.g.
    :func:`.cosearch.miqp_anchor`) — capped enumerations then spend
    their candidate budget around the proposal instead of the uniform
    split. ``anchors=None`` is the uniform-anchored search, bit for
    bit."""
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}; "
                         f"one of {OBJECTIVES}")
    G = len(tasks)
    assert G == len(hws) and G > 0
    if anchors is not None and len(anchors) != G:
        raise ValueError(f"anchors must align with points: "
                         f"{len(anchors)} != {G}")
    if cfg.devices not in DEVICE_MODES:
        raise ValueError(f"bad devices {cfg.devices!r}; "
                         f"one of {DEVICE_MODES}")
    backend = resolve_auto_backend(cfg.backend, cfg.score_chunk)
    n = len(tasks[0])
    spaces = [_Space(t, h, cfg,
                     anchor=None if anchors is None else anchors[g])
              for g, (t, h) in enumerate(zip(tasks, hws))]

    # Mode is a per-point decision (it must not depend on grouping).
    exact = [g for g in range(G)
             if spaces[g].joint <= max(1, cfg.candidate_budget)]
    beam = [g for g in range(G) if g not in exact]
    results: list[MIQPResult | None] = [None] * G

    def run_subset(idxs: list[int], mode: str) -> None:
        sub = [spaces[g] for g in idxs]
        if mode == "beam":
            # Deterministic per-layer cap from the eval budget: one beam
            # pass costs ~W candidates per layer slot, each refinement
            # sweep ~1 (descent is bounded separately by its move count).
            cap = max(1, cfg.eval_budget // max(
                1, n * (cfg.beam_width + max(1, cfg.refine_sweeps))))
            cap = min(cap, cfg.max_layer_candidates)
            for sp in sub:
                sp.recap(cap)
        scorer = _GroupScorer([tasks[g] for g in idxs],
                              [hws[g] for g in idxs], sub, options,
                              objective, backend, cfg.score_chunk,
                              device=cfg.device, devices=cfg.devices)
        if mode == "exact":
            best_a, best = _solve_exact(sub, scorer)
        else:
            best_a, best = _solve_beam(sub, scorer, cfg)
            best_a, best = _pair_refine(sub, scorer, best_a, best, cfg)
        Ux = np.stack([sp.units(best_a[k])[0] for k, sp in enumerate(sub)])
        Uy = np.stack([sp.units(best_a[k])[1] for k, sp in enumerate(sub)])
        Ux, Uy, best, moves = _unit_descent(sub, scorer, Ux, Uy, best, cfg)
        for k, g in enumerate(idxs):
            task, hw = tasks[g], hws[g]
            Px, Py = sub[k].unpad(Ux[k][None], Uy[k][None])
            part = Partition(Px[0].astype(np.int64),
                             Py[0].astype(np.int64),
                             np.full(n, hw.Y // 2, dtype=np.int64))
            part.validate(task)
            rd = scorer.evs[k].chain_valid & options.redistribution
            if mode == "exact":
                status = (f"lattice exact: {sub[k].joint} candidates"
                          + ("" if sub[k].complete else " (capped sets)")
                          + f", +{moves[k]} descent moves")
            else:
                status = (f"lattice beam: W={cfg.beam_width}, "
                          f"cap={max(sub[k].sizes)}, "
                          f"+{moves[k]} descent moves")
            mobj = float(best[k]) * 1e6 if objective == "latency" else -1.0
            results[g] = MIQPResult(part, rd, float(best[k]), status,
                                    mobj, engine="lattice")

    if exact:
        run_subset(exact, "exact")
    if beam:
        run_subset(beam, "beam")
    return results  # type: ignore[return-value]


solve_lattice_batch.score_calls = 0
