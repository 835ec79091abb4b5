"""Multi-tenant placement on one MCM package (DESIGN.md §18) — the
port's copy of the JAX package's ``core/multitenant.py``, with
``"torch"`` where it has ``"jax"``.

Several models co-resident on a single (possibly heterogeneous) chiplet
grid: each tenant gets a contiguous *row band* of the mesh, the bands
are disjoint and cover the grid, assignment candidates are enumerated
deterministically (:func:`band_assignments`), and every tenant is solved
*inside its band* by one of the engines (GA / MIQP lattice / the
LS-uniform baseline) through :func:`.sweep.solve_grid` — so the search
engines share one tenant partition/decode path and the §9 sweep cache
dedupes identical region solves across assignments.

Scoring is two-stage:

  1. **Solo** — each tenant's chosen schedule is re-scored exactly by
     the evaluator on its *region* hardware (:func:`region_hw`: the band
     becomes an ``(x1−x0)×Y`` sub-package with a proportional share of
     the off-chip bandwidth and the matching slice of the chiplet-class
     assignment — hardware is data, so a region is just another
     HWConfig).
  2. **Contention** — tenants share the package NoP: one pull flow per
     chiplet on the *package* flow network (``Topology.flow_net()``,
     hetero link caps included) carries each tenant's input bytes spread
     over its band; the max-min waterfilling netsim runs once per tenant
     alone and once jointly, and the per-tenant slowdown (joint/solo
     completion, ≥ 1) stretches the tenant's input-load phase. A
     tenant's demand depends only on the tasks, the band and ``hw``,
     never on the inner solve, so on the torch backend every simulation
     of one solve — the joint and solo demands of every assignment —
     runs as scenarios of the one package network in ONE call of
     :func:`repro_torch.kernels.netsim.ops.waterfill` (one launch of the
     hand-written waterfilling kernel on the card, its plain version on
     the CPU), bit for bit the numpy engine's per-assignment
     ``simulate_flows`` loop that the numpy backend keeps.

Package latency is the max over tenants (they run concurrently),
package energy the sum; the best assignment wins by strict ``<`` on the
requested objective with the lexicographically-first candidate as the
deterministic tie-break. The naive even-split assignment is always in
the candidate set, so the search result is never worse than it.

All budgets are deterministic counts (assignment enumeration order,
inner-solver budgets); there is no wall-clock anywhere, so a point
solved alone equals the same point solved in a batch — the §9 contract.
With ``method="cosearch"`` each tenant's region runs the fused co-search
(:func:`.sweep.cosearch_sweep`, torch backend only), and a record's diag
gene folds into the hardware its tenant is scored on.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.netsim import ops
from .evaluator import EvalOptions
from .hw import HWConfig
from .workload import Partition, Task, _split_even, uniform_partition

__all__ = [
    "MultiTenantConfig",
    "MultiTenantResult",
    "TENANT_METHODS",
    "band_assignments",
    "even_split_assignment",
    "region_hw",
    "solve_multitenant",
]

#: Inner per-tenant solvers ("uniform" = the LS baseline, no search).
TENANT_METHODS = ("uniform", "ga", "miqp", "cosearch")


@dataclasses.dataclass(frozen=True)
class MultiTenantConfig:
    """Search configuration for :func:`solve_multitenant`.

    ``method``/``cfg`` pick the inner per-tenant engine and its (frozen)
    config — a search engine, or ``"uniform"`` for the LS baseline.
    ``contention=False`` skips the joint netsim (solo scores only).
    ``max_assignments`` caps the deterministic band-composition
    enumeration (lexicographic prefix; the even split is always kept).
    ``devices`` follows the §15 knob and is normalized out of
    fingerprints.
    """

    method: str = "ga"
    cfg: Any = None
    contention: bool = True
    max_assignments: int = 64
    devices: str = "auto"

    def __post_init__(self):
        if self.method not in TENANT_METHODS:
            raise ValueError(f"unknown tenant method {self.method!r}; "
                             f"one of {TENANT_METHODS}")
        if self.max_assignments < 1:
            raise ValueError("max_assignments must be >= 1")


@dataclasses.dataclass(frozen=True)
class MultiTenantResult:
    """Best placement found: per-tenant row bands + schedules + scores.

    ``assignment`` is a tuple of per-tenant ``(x0, x1)`` row bands
    (disjoint, covering), ``partitions`` the per-tenant
    :class:`Partition` inside each band, ``per_tenant`` a tuple of dicts
    (latency/energy/edp/slowdown per tenant under the winning
    assignment), ``baseline`` the even-split scores the search must not
    lose to, ``evaluations`` the summed inner-solver evaluation counts.
    """

    assignment: tuple
    partitions: tuple
    objective: float
    latency: float
    energy: float
    edp: float
    per_tenant: tuple
    baseline: dict
    evaluations: int

    def copy(self) -> "MultiTenantResult":
        return MultiTenantResult(
            assignment=self.assignment,
            partitions=tuple(p.copy() for p in self.partitions),
            objective=self.objective,
            latency=self.latency,
            energy=self.energy,
            edp=self.edp,
            per_tenant=tuple(dict(d) for d in self.per_tenant),
            baseline=dict(self.baseline),
            evaluations=self.evaluations,
        )


# ------------------------------------------------------- band enumeration
def band_assignments(X: int, n_tenants: int,
                     max_assignments: int = 64) -> list[tuple]:
    """All contiguous row-band placements of ``n_tenants`` tenants on an
    ``X``-row mesh, as tuples of per-tenant ``(x0, x1)`` bands (disjoint,
    covering, tenant order fixed).

    Enumeration is the lexicographic cut-point order of
    ``itertools.combinations`` — deterministic, so budgets are counts.
    Truncation keeps the lexicographic prefix but always retains the
    even-split candidate (the baseline the search must dominate)."""
    if not 1 <= n_tenants <= X:
        raise ValueError(f"need 1 <= n_tenants <= X rows, got "
                         f"{n_tenants} tenants on {X} rows")
    out = []
    for cuts in itertools.combinations(range(1, X), n_tenants - 1):
        edges = (0,) + cuts + (X,)
        out.append(tuple((edges[i], edges[i + 1])
                         for i in range(n_tenants)))
    if len(out) > max_assignments:
        even = even_split_assignment(X, n_tenants)
        out = out[:max_assignments]
        if even not in out:
            out[-1] = even
    return out


def even_split_assignment(X: int, n_tenants: int) -> tuple:
    """The naive baseline: rows split as evenly as possible, remainder
    spread over the leading tenants (same convention as the partition
    layer's ``_split_even``)."""
    sizes = _split_even(X, n_tenants)
    edges = np.concatenate([[0], np.cumsum(sizes)])
    return tuple((int(edges[i]), int(edges[i + 1]))
                 for i in range(n_tenants))


# --------------------------------------------------------- region decode
def region_hw(hw: HWConfig, x0: int, x1: int) -> HWConfig:
    """The sub-package a tenant band ``[x0, x1)`` sees: an
    ``(x1−x0)×Y`` grid with a row-proportional share of the off-chip
    bandwidth and the matching row slice of the chiplet-class
    assignment — an ordinary :class:`HWConfig` every engine accepts."""
    if not 0 <= x0 < x1 <= hw.X:
        raise ValueError(f"band [{x0}, {x1}) out of range for X={hw.X}")
    rows = x1 - x0
    kw = dict(X=rows, bw_mem=hw.bw_mem * rows / hw.X)
    if hw.is_hetero:
        kw["class_assignment"] = hw.class_assignment[x0 * hw.Y:x1 * hw.Y]
    return dataclasses.replace(hw, **kw)


def _decode_schedule(rec, method: str, region: HWConfig
                     ) -> tuple[Partition, np.ndarray, HWConfig, int]:
    """Shared decode of any engine's solver record into the exact-scoring
    genome: (partition, redist_mask, scoring hw, evaluations). A
    co-search record's diag gene folds into the scoring hardware."""
    score_hw = region
    if method == "cosearch" and getattr(rec, "diagonal", False):
        score_hw = dataclasses.replace(region, diagonal_links=True)
    return (rec.partition, np.asarray(rec.redist_mask, dtype=bool),
            score_hw, int(getattr(rec, "evaluations", 0)))


def _solve_tenants(tasks, regions, objective, options, cfg,
                   backend, cache, devices, device=None):
    """One inner solve + exact eval per tenant; returns
    (partitions, eval records, scoring hws, evaluation count)."""
    from . import sweep

    parts, rds, score_hws, evals = [], [], [], 0
    if cfg.method == "uniform":
        for task, region in zip(tasks, regions):
            parts.append(uniform_partition(task, region.X, region.Y))
            rds.append(None)
            score_hws.append(region)
    else:
        pts = [sweep.EvalPoint(task, region, options)
               for task, region in zip(tasks, regions)]
        recs = sweep.solve_grid(pts, objective=objective, cfg=cfg.cfg,
                                backend=backend, cache=cache,
                                method=cfg.method, devices=devices,
                                device=device)
        for rec, region in zip(recs, regions):
            part, rd, score_hw, ev_n = _decode_schedule(
                rec, cfg.method, region)
            parts.append(part)
            rds.append(rd)
            score_hws.append(score_hw)
            evals += ev_n
    eval_pts = [
        sweep.EvalPoint(task, hw2, options, partition=part,
                        redist_mask=rd)
        for task, hw2, part, rd in zip(tasks, score_hws, parts, rds)]
    recs = sweep.eval_sweep(eval_pts, backend=backend, cache=cache,
                            devices=devices, device=device)
    evals += len(eval_pts)
    return parts, recs, score_hws, evals


# ------------------------------------------------------------ contention
def _tenant_demand(task: Task, band: tuple[int, int], hw: HWConfig
                   ) -> np.ndarray:
    """Per-chiplet input bytes ``[X·Y]``: the tenant's total load-phase
    traffic (activations + weights) spread evenly over its band."""
    arr = task.arrays()
    total = float(((arr["M"] * arr["K"]
                    + arr["K"] * arr["N"] * arr["w_scale"]).sum())
                  * hw.bytes_per_elem)
    x0, x1 = band
    demand = np.zeros(hw.X * hw.Y, dtype=np.float64)
    idx = np.arange(x0 * hw.Y, x1 * hw.Y)
    demand[idx] = total / len(idx)
    return demand


def _band_demands(tasks, assignment, hw: HWConfig, routed) -> list:
    """Each tenant's routed demand under ``assignment``. Routeless
    chiplets (on their entrance / under a 3D stack) are masked to zero
    bytes, exactly like the evaluator's flow mode."""
    return [_tenant_demand(t, band, hw) * routed
            for t, band in zip(tasks, assignment)]


def _slowdown(demand, done_solo, done_joint) -> float:
    """One tenant's slowdown (≥ 1): the largest joint/solo completion
    ratio over its live flows."""
    live = demand > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(live & (done_solo > 0),
                         done_joint / np.where(done_solo > 0,
                                               done_solo, 1.0), 1.0)
    return max(1.0, float(ratio.max()))


def _contention_slowdowns(tasks, assignment, hw: HWConfig) -> np.ndarray:
    """Per-tenant NoP contention slowdowns (≥ 1) of one assignment from
    the shared package flow netsim (numpy engine): joint vs solo
    completion of each tenant's band flows."""
    from . import netsim

    caps, dist_inc, _ = hw.topology.flow_net()
    routed = dist_inc.sum(axis=1) > 0
    demands = _band_demands(tasks, assignment, hw, routed)
    joint = np.sum(demands, axis=0)
    if not joint.any():
        return np.ones(len(tasks))
    done_joint = netsim.simulate_flows(dist_inc, caps, joint)["done"]
    slow = np.ones(len(tasks))
    for t, demand in enumerate(demands):
        if not demand.any():
            continue
        done_solo = netsim.simulate_flows(dist_inc, caps, demand)["done"]
        slow[t] = _slowdown(demand, done_solo, done_joint)
    return slow


def _contention_slowdowns_batch(tasks, assignments, hw: HWConfig,
                                device=None) -> np.ndarray:
    """:func:`_contention_slowdowns` of every assignment ``[A, T]``, all
    simulations in ONE waterfilling call on ``device`` (``None``: the
    card): the joint and the non-empty solo demands of every assignment
    are scenarios ``[1, S, F]`` of the package network. The early outs
    stay on the host (an assignment with no joint bytes, a tenant with
    no bytes), so the call runs exactly the numpy engine's simulations,
    and the ratios are taken on the host from ``done``."""
    caps, dist_inc, _ = hw.topology.flow_net()
    routed = dist_inc.sum(axis=1) > 0
    scenarios: list[np.ndarray] = []
    plan: list = []            # per assignment: (joint row, solo rows)
    for assignment in assignments:
        demands = _band_demands(tasks, assignment, hw, routed)
        joint = np.sum(demands, axis=0)
        if not joint.any():
            plan.append(None)
            continue
        j = len(scenarios)
        scenarios.append(joint)
        solos = []
        for t, demand in enumerate(demands):
            if demand.any():
                solos.append((t, len(scenarios), demand))
                scenarios.append(demand)
        plan.append((j, solos))
    slow = np.ones((len(assignments), len(tasks)))
    dev = resolve_device(device)
    if not scenarios:
        return slow
    f8 = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.float64)).to(dev)
    if dev.type == "cuda":         # the kernel reads the route lists only
        inc, routes = None, torch.from_numpy(
            ops.route_lists(dist_inc[None])).to(dev)
    else:
        inc, routes = f8(dist_inc[None]), None
    _, done, _, _ = ops.waterfill(f8(caps[None]), inc,
                                  f8(np.stack(scenarios)[None]),
                                  routes=routes, link_bytes=False)
    done = done[0].cpu().numpy()
    if np.isnan(done).any():
        # The numpy engine raises where the batched engines report NaN.
        raise RuntimeError("contention simulation stalled or did not "
                           "converge")
    for a, p in enumerate(plan):
        if p is None:
            continue
        j, solos = p
        for t, s, demand in solos:
            slow[a, t] = _slowdown(demand, done[s], done[j])
    return slow


# --------------------------------------------------------------- search
def solve_multitenant(
    tasks: Sequence[Task],
    hw: HWConfig,
    objective: str = "edp",
    options: EvalOptions | None = None,
    cfg: MultiTenantConfig = MultiTenantConfig(),
    backend: str = "torch",
    cache: bool = True,
    devices: str | None = None,
    device=None,
) -> MultiTenantResult:
    """Search row-band placements of ``tasks`` on ``hw`` and return the
    best package schedule (module docstring has the model).

    ``objective`` is ``"edp"`` / ``"latency"`` / ``"energy"`` — the
    package-level score both the inner solvers and the assignment
    selection optimize. The even-split baseline is always scored (and
    returned in ``result.baseline``), and the candidate set contains it,
    so ``result.objective <= baseline[objective]`` by construction.

    ``backend`` is ``"numpy"`` (the reference: host engines, one
    ``simulate_flows`` per contention simulation), ``"torch"`` (inner
    solves and evaluations on ``device``, ``None`` meaning the card;
    all contention of the solve in one waterfilling launch) or
    ``"auto"`` (torch)."""
    if options is None:
        options = EvalOptions()
    if objective not in ("edp", "latency", "energy"):
        raise ValueError(f"unknown objective {objective!r}; "
                         f"one of ('edp', 'latency', 'energy')")
    if backend == "auto":
        backend = "torch"
    if backend not in ("numpy", "torch"):
        raise ValueError(f"unknown backend {backend!r}; "
                         f"one of ('numpy', 'torch', 'auto')")
    tasks = tuple(tasks)
    if not tasks:
        raise ValueError("need at least one tenant task")
    if len(tasks) > hw.X:
        raise ValueError(f"{len(tasks)} tenants need {len(tasks)} row "
                         f"bands but the grid has X={hw.X} rows")
    hw.validate()

    assignments = band_assignments(hw.X, len(tasks),
                                   cfg.max_assignments)
    even = even_split_assignment(hw.X, len(tasks))
    slows = None
    if cfg.contention and backend == "torch":
        slows = _contention_slowdowns_batch(tasks, assignments, hw, device)
    best = None
    baseline: dict[str, Any] = {}
    total_evals = 0
    for a, assignment in enumerate(assignments):
        regions = [region_hw(hw, x0, x1) for x0, x1 in assignment]
        parts, recs, score_hws, evals = _solve_tenants(
            tasks, regions, objective, options, cfg, backend, cache,
            devices, device)
        total_evals += evals
        if cfg.contention:
            slow = (slows[a] if slows is not None
                    else _contention_slowdowns(tasks, assignment, hw))
            total_evals += len(tasks) + 1
        else:
            slow = np.ones(len(tasks))
        per_tenant = []
        for rec, s in zip(recs, slow):
            lat = float(rec["latency"]
                        + float(rec["t_in"].sum()) * (s - 1.0))
            per_tenant.append({
                "latency": lat, "energy": float(rec["energy"]),
                "edp": float(rec["energy"]) * lat, "slowdown": float(s),
            })
        latency = max(d["latency"] for d in per_tenant)
        energy = sum(d["energy"] for d in per_tenant)
        scores = {"latency": latency, "energy": energy,
                  "edp": energy * latency}
        if assignment == even:
            baseline = {"assignment": even, **scores}
        if best is None or scores[objective] < best[0]:
            best = (scores[objective], assignment, tuple(parts),
                    tuple(per_tenant), scores)
    assert best is not None and baseline, "even split must be scored"
    _, assignment, parts, per_tenant, scores = best
    return MultiTenantResult(
        assignment=assignment,
        partitions=parts,
        objective=best[0],
        latency=scores["latency"],
        energy=scores["energy"],
        edp=scores["edp"],
        per_tenant=per_tenant,
        baseline=baseline,
        evaluations=total_evals,
    )
