"""Cross-sample pipelining — paper Sec. 5.4 / Fig. 7 / Fig. 11.

Within one sample the GEMM chain is sequential, but samples of a batch are
independent, so communication of one sample can overlap computation of
another. The paper casts this as a resource-constrained project scheduling
problem (RCPSP) with two unit-capacity resources — the NoP ("comm") and the
chiplet array ("comp") — and solves it with an ILP.

Three engines (DESIGN.md §13), selected by :class:`PipelineConfig`:

  * ``engine="python"`` — the serial critical-path-first priority list
    scheduler (heapq SGS); behavioral reference.
  * ``engine="vectorized"`` (the ``"auto"`` default) — the batched SGS
    of :mod:`.pipelining_torch`: the regular job structure (every sample
    emits the same (in, comp, out) chain) makes priorities a reversed
    cumulative sum and the ready set a per-sample frontier, so whole
    (workload × batch × segment-variant) grids schedule through one call
    per shape group (``backend="torch"``: a hand-written CUDA kernel on
    the card, its plain PyTorch version on the CPU; ``backend="numpy"``
    runs the same frontier loop on the host as the parity reference).
    Exact — bit-identical makespans/starts vs the python engine.
  * ``engine="milp"`` — the paper's time-indexed RCPSP ILP via HiGHS
    (wall-clock budgeted). The bucket solution is re-simulated through
    the SGS so the reported (makespan, starts) is a *feasible*
    continuous-time schedule covering every job.

Durations come from the evaluator's per-op (comm_in, comp, comm_out)
breakdown (``api.ScheduleResult.pipeline``).

The port's copy of the JAX package's ``core/pipelining.py``.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

__all__ = ["Job", "build_jobs", "list_schedule", "milp_schedule",
           "sequential_makespan", "PipelineResult", "pipeline_batch",
           "PipelineConfig", "PIPELINE_ENGINES",
           "resolve_auto_pipeline_engine", "vectorized_schedule"]

COMM, COMP = "comm", "comp"

#: Scheduler engines (DESIGN.md §13). ``"auto"`` resolves to
#: ``"vectorized"`` — exact vs the python reference (bit-identical, not
#: just rtol) and batchable across sweep grids.
PIPELINE_ENGINES = ("python", "vectorized", "milp", "auto")


def resolve_auto_pipeline_engine(engine: str) -> str:
    """Resolve ``"auto"`` to a concrete scheduler engine. Mirrors
    :func:`.miqp.resolve_auto_engine`: the vectorized SGS is exact vs
    the serial reference and batches whole grids, so it wins
    everywhere."""
    if engine == "auto":
        return "vectorized"
    if engine not in PIPELINE_ENGINES:
        raise ValueError(f"unknown engine {engine!r}; "
                         f"one of {PIPELINE_ENGINES}")
    return engine


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Scheduler selection + MILP knobs (frozen → usable as a sweep-cache
    key component, like ``GAConfig``/``MIQPConfig``).

    ``backend`` applies to the vectorized engine only: ``"torch"`` runs
    the batched SGS (:mod:`.pipelining_torch`) on ``device`` (``None``:
    the card), ``"numpy"`` the host frontier loop (parity reference).
    ``"auto"`` resolves to numpy for a solo :func:`pipeline_batch` call
    (no device round trip) and to torch inside
    :func:`.sweep.pipeline_sweep` (grid batching always wins) — both
    produce bit-identical schedules, so the resolution is a pure
    performance choice."""

    engine: str = "auto"       # python | vectorized | milp | auto
    backend: str = "auto"      # numpy | torch | auto (vectorized engine)
    n_buckets: int = 64        # milp time-bucket count
    time_limit: float = 30.0   # milp wall-clock budget (seconds)
    devices: str = "auto"      # grid-axis execution of batched schedules:
                               # "single" | "sharded" | "auto" (§15).
                               # Result-neutral — never part of a cache
                               # fingerprint
    device: str | None = None  # torch device (None: the card)


@dataclasses.dataclass
class Job:
    jid: int
    sample: int
    op: int
    kind: str          # "in" | "comp" | "out"
    dur: float
    resource: str      # COMM or COMP
    preds: list[int]


def build_jobs(segments: list[tuple[str, float, float, float]],
               batch: int) -> list[Job]:
    """``segments`` = per-op (name, t_in, t_comp, t_out) for ONE sample."""
    jobs: list[Job] = []
    for s in range(batch):
        prev = -1
        for i, (_, tin, tcomp, tout) in enumerate(segments):
            trip = [("in", tin, COMM), ("comp", tcomp, COMP),
                    ("out", tout, COMM)]
            for kind, dur, res in trip:
                preds = [prev] if prev >= 0 else []
                j = Job(len(jobs), s, i, kind, float(max(dur, 0.0)), res,
                        preds)
                jobs.append(j)
                prev = j.jid
    return jobs


def sequential_makespan(segments, batch: int) -> float:
    return batch * float(sum(t1 + t2 + t3 for _, t1, t2, t3 in segments))


def _critical_path(jobs: list[Job]) -> np.ndarray:
    """Longest path from each job to the sink (priority for the SGS)."""
    succ: dict[int, list[int]] = {j.jid: [] for j in jobs}
    for j in jobs:
        for p in j.preds:
            succ[p].append(j.jid)
    prio = np.zeros(len(jobs))
    for j in reversed(jobs):  # jobs are topologically ordered by build
        tail = max((prio[s] for s in succ[j.jid]), default=0.0)
        prio[j.jid] = j.dur + tail
    return prio


def _sgs(jobs: list[Job], prio: np.ndarray
         ) -> tuple[float, dict[int, float]]:
    """Serial schedule-generation scheme under a given priority vector:
    repeatedly dispatch the highest-priority *ready* job (predecessors
    all scheduled) at the earliest time its resource and its chain allow.

    The heap can only run dry with all jobs scheduled: every job starts
    with ``indeg == len(preds)``, the indeg-0 set seeds the heap, and
    each pop decrements its successors' indegs, pushing any that reach
    zero — Kahn's invariant, so for acyclic input some job is ready
    whenever ``done < n``.
    """
    n = len(jobs)
    indeg = {j.jid: len(j.preds) for j in jobs}
    ready_time = {j.jid: 0.0 for j in jobs}
    free = {COMM: 0.0, COMP: 0.0}
    start: dict[int, float] = {}
    done = 0
    # ready heap keyed by (-priority, jid)
    heap = [(-prio[j.jid], j.jid) for j in jobs if indeg[j.jid] == 0]
    heapq.heapify(heap)
    succ: dict[int, list[int]] = {j.jid: [] for j in jobs}
    for j in jobs:
        for p in j.preds:
            succ[p].append(j.jid)
    byid = {j.jid: j for j in jobs}
    makespan = 0.0
    while done < n:
        _, jid = heapq.heappop(heap)
        j = byid[jid]
        t0 = max(ready_time[jid], free[j.resource])
        start[jid] = t0
        t1 = t0 + j.dur
        free[j.resource] = t1
        makespan = max(makespan, t1)
        done += 1
        for s in succ[jid]:
            ready_time[s] = max(ready_time[s], t1)
            indeg[s] -= 1
            if indeg[s] == 0:
                heapq.heappush(heap, (-prio[s], s))
    return makespan, start


def list_schedule(jobs: list[Job]) -> tuple[float, dict[int, float]]:
    """Serial schedule-generation scheme, critical-path-first."""
    return _sgs(jobs, _critical_path(jobs))


# ------------------------------------------------- vectorized engine
def _segment_durations(segments) -> np.ndarray:
    """Per-sample flattened job durations ``[3n]``, clamped like
    :func:`build_jobs` (in, comp, out per op)."""
    durs = np.array([[tin, tcomp, tout]
                     for _, tin, tcomp, tout in segments], dtype=np.float64)
    durs = durs.reshape(-1) if durs.size else np.zeros(0)
    return np.maximum(durs, 0.0)


def chain_priorities(dur_flat: np.ndarray) -> np.ndarray:
    """Critical-path priorities of one sample's job chain as a reversed
    cumulative sum — the only successor of chain job ``p`` is ``p+1``,
    so ``prio[p] = dur[p] + prio[p+1]``; ``np.cumsum`` over the reversed
    durations performs the *same* sequence of pairwise additions as the
    per-job :func:`_critical_path` walk (IEEE addition is commutative),
    so the priorities are bit-identical, and tie-breaks — which compare
    float priorities exactly — cannot diverge across engines."""
    return np.cumsum(dur_flat[::-1])[::-1].copy()


def _frontier_schedule_host(dur_flat: np.ndarray, prio: np.ndarray,
                            batch: int) -> tuple[float, np.ndarray]:
    """Host reference of the batched SGS step (DESIGN.md §13).

    Because every sample runs the same chain, the ready set is exactly
    the per-sample *frontier* (the next unscheduled chain position): a
    pop makes its chain successor ready immediately, so the heap always
    holds one entry per unfinished sample. Each step therefore dispatches
    ``argmax`` priority over the frontiers (ties → smallest jid, the
    heap's tie-break) onto its unit resource — the same pop sequence,
    and bit-identical arithmetic, as :func:`list_schedule`. Returns
    ``(makespan, starts [batch, 3n])``."""
    L = dur_flat.shape[0]
    res = np.tile(np.array([0, 1, 0], dtype=np.int64), L // 3)
    ptr = np.zeros(batch, dtype=np.int64)
    ready = np.zeros(batch, dtype=np.float64)
    free = np.zeros(2, dtype=np.float64)
    starts = np.zeros((batch, L), dtype=np.float64)
    sample_base = np.arange(batch, dtype=np.int64) * L
    for _ in range(batch * L):
        active = ptr < L
        pr = np.where(active, prio[np.minimum(ptr, L - 1)], -np.inf)
        cand = np.where(active & (pr == pr.max()), sample_base + ptr,
                        batch * L)
        s = int(np.argmin(cand))
        p = int(ptr[s])
        r = int(res[p])
        t0 = max(ready[s], free[r])
        t1 = t0 + dur_flat[p]
        starts[s, p] = t0
        free[r] = t1
        ready[s] = t1
        ptr[s] += 1
    return float(free.max(initial=0.0)), starts


def vectorized_schedule(segments, batch: int, backend: str = "numpy",
                        device=None) -> tuple[float, np.ndarray]:
    """Vectorized list schedule for one (segments, batch) instance:
    ``(makespan, starts [batch, 3n])`` with ``starts[s, p]`` the start of
    sample ``s``'s p-th chain job (jid ``s*3n + p`` in
    :func:`build_jobs` order). ``backend="torch"`` is the ``G=1`` case
    of :func:`.pipelining_torch.schedule_batch` on ``device`` — the same
    program the sweep engine batches, so solo == batched exactly."""
    dur = _segment_durations(segments)
    if backend == "torch":
        from . import pipelining_torch

        out = pipelining_torch.schedule_batch(dur.reshape(1, -1, 3), batch,
                                              device=device)
        return float(out["makespan"][0]), out["starts"][0]
    if backend != "numpy":
        raise ValueError(f"unknown backend {backend!r}; "
                         f"one of ('numpy', 'torch')")
    return _frontier_schedule_host(dur, chain_priorities(dur), batch)


def milp_schedule(jobs: list[Job], n_buckets: int = 64,
                  time_limit: float = 60.0
                  ) -> tuple[float, dict[int, float]]:
    """Time-indexed RCPSP MILP (the paper's ILP). Falls back to the list
    schedule if the model is too large or the solver finds nothing better.

    The returned pair is always a *feasible continuous-time schedule
    covering every job* (zero-duration jobs included): the MILP's
    bucket-quantized solution fixes a job priority order, which is
    re-simulated through the SGS — bucket rounding can violate
    continuous-time precedence/resource feasibility by up to one bucket
    width, so the raw ``res.x[cmax] * dt`` objective is a bound, not a
    schedule."""
    import scipy.sparse as sp
    from scipy.optimize import Bounds, LinearConstraint, milp

    ub_makespan, greedy_start = list_schedule(jobs)
    if ub_makespan <= 0:
        return ub_makespan, greedy_start
    active = [j for j in jobs if j.dur > 0]
    if len(active) * n_buckets > 60000:
        return ub_makespan, greedy_start
    dt = ub_makespan / n_buckets
    d = {j.jid: max(1, int(np.ceil(j.dur / dt))) for j in active}
    H = n_buckets + max(d.values())

    nv = 0
    var = {}
    for j in active:
        for t in range(H - d[j.jid] + 1):
            var[j.jid, t] = nv
            nv += 1
    cmax = nv
    nv += 1

    rows, lo, hi = [], [], []

    def add(idx, coef, l, h):
        rows.append((idx, coef))
        lo.append(l)
        hi.append(h)

    for j in active:
        ids = [var[j.jid, t] for t in range(H - d[j.jid] + 1)]
        add(ids, [1.0] * len(ids), 1.0, 1.0)
        # makespan
        add([cmax] + ids,
            [1.0] + [-(t + d[j.jid]) for t in range(len(ids))], 0.0, np.inf)

    # precedence (pred may be zero-duration → collapse to nearest active)
    startexpr = {}
    for j in active:
        startexpr[j.jid] = ([var[j.jid, t]
                             for t in range(H - d[j.jid] + 1)],
                            list(range(H - d[j.jid] + 1)))
    act_ids = {j.jid for j in active}
    byid = {j.jid: j for j in jobs}

    def resolve_pred(p):  # walk through zero-duration predecessors
        stack = [p]
        out = []
        while stack:
            q = stack.pop()
            if q in act_ids:
                out.append(q)
            else:
                stack.extend(byid[q].preds)
        return out

    for j in active:
        for p in j.preds:
            for q in resolve_pred(p):
                ji, jc = startexpr[j.jid]
                qi, qc = startexpr[q]
                add(ji + qi, [float(c) for c in jc] + [-float(c) for c in qc],
                    float(d[q]), np.inf)

    # resource capacity per bucket
    for res in (COMM, COMP):
        members = [j for j in active if j.resource == res]
        for tau in range(H):
            idx = []
            for j in members:
                for t in range(max(0, tau - d[j.jid] + 1),
                               min(tau, H - d[j.jid]) + 1):
                    idx.append(var[j.jid, t])
            if len(idx) > 1:
                add(idx, [1.0] * len(idx), -np.inf, 1.0)

    data, ri, ci = [], [], []
    for r, (idx, coef) in enumerate(rows):
        for jj, a in zip(idx, coef):
            ri.append(r)
            ci.append(jj)
            data.append(a)
    A = sp.csr_matrix((data, (ri, ci)), shape=(len(rows), nv))
    c = np.zeros(nv)
    c[cmax] = 1.0
    integrality = np.ones(nv, dtype=int)
    integrality[cmax] = 0
    res = milp(c=c,
               constraints=LinearConstraint(A, np.array(lo), np.array(hi)),
               integrality=integrality,
               bounds=Bounds(np.zeros(nv),
                             np.concatenate([np.ones(nv - 1), [np.inf]])),
               options={"time_limit": time_limit, "presolve": True})
    if res.x is None:
        return ub_makespan, greedy_start

    # Bucket starts for active jobs; zero-duration jobs sit at their
    # resolved predecessor finish (topological fill — build order is
    # topological), so the priority order below covers EVERY job.
    bucket_start: dict[int, float] = {}
    for (jid, t), v in var.items():
        if res.x[v] > 0.5:
            bucket_start[jid] = t * dt
    for j in jobs:
        if j.jid not in bucket_start:
            bucket_start[j.jid] = max(
                (bucket_start[p] + byid[p].dur for p in j.preds),
                default=0.0)

    # Re-simulate the MILP's job order through the SGS: the certified
    # continuous-time schedule (the bucket objective is only a bound).
    order = sorted(bucket_start, key=lambda jid: (bucket_start[jid], jid))
    prio = np.zeros(len(jobs))
    for rank, jid in enumerate(order):
        prio[jid] = float(len(order) - rank)
    ms_sim, starts_sim = _sgs(jobs, prio)
    if ms_sim >= ub_makespan:
        return ub_makespan, greedy_start
    return ms_sim, starts_sim


@dataclasses.dataclass
class PipelineResult:
    batch: int
    sequential: float
    pipelined: float
    engine: str = "python"     # resolved scheduler engine (DESIGN.md §13)

    @property
    def speedup(self) -> float:
        return self.sequential / self.pipelined if self.pipelined > 0 else 1.0

    @property
    def per_sample(self) -> float:
        return self.pipelined / self.batch


def pipeline_batch(segments, batch: int, use_milp: bool = False,
                   time_limit: float = 30.0,
                   config: PipelineConfig | None = None) -> PipelineResult:
    """Schedule one (segments, batch) pipelining instance.

    ``config`` selects the engine (DESIGN.md §13); ``use_milp=True`` is
    the legacy spelling of ``PipelineConfig(engine="milp")``. Batched
    grids should go through :func:`.sweep.pipeline_sweep` instead — one
    call per (n_ops, batch) shape group."""
    cfg = config or PipelineConfig()
    if use_milp:
        cfg = dataclasses.replace(cfg, engine="milp", time_limit=time_limit)
    engine = resolve_auto_pipeline_engine(cfg.engine)
    if engine == "milp":
        ms, _ = milp_schedule(build_jobs(segments, batch),
                              n_buckets=cfg.n_buckets,
                              time_limit=cfg.time_limit)
    elif engine == "python":
        ms, _ = list_schedule(build_jobs(segments, batch))
    else:
        backend = "numpy" if cfg.backend == "auto" else cfg.backend
        ms, _ = vectorized_schedule(segments, batch, backend=backend,
                                    device=cfg.device)
    return PipelineResult(batch, sequential_makespan(segments, batch), ms,
                          engine=engine)
