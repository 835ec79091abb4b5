"""MIQP scheduler — paper Sec. 6.3.

The paper formulates workload partitioning as a mixed-integer *quadratic*
program (compute time is the product Px·Py, redistribution gathers are
partition×partition products) and applies two tricks to make it solvable:
(1) multiply constant denominators through the equations, with a global
scaling factor to keep coefficient magnitudes sane, and (2) a first-order
replacement ``1/(c+x) ≈ (c−x)/c²`` for variable denominators.

We go one step further: on the paper's own constrained search space
(partitions are multiples of R within ±slack units of uniform — Sec. 6.2)
every quadratic term is a product of *small-domain integer* variables, so
the QP linearizes **exactly** to an MILP via binary choice expansion:

  * ``u[i,x] = Σ_a val_a·z[i,x,a]``  (one-hot choice binaries),
  * ``max_x u[i,x]`` via one-hot epigraph selection ``mxz``,
  * products ``mx·my`` via ``q_ab ≥ mxz_a + myz_b − 1`` (objective pressure
    makes the relaxation tight),
  * choice×affine products via exact binary McCormick envelopes.

Trick (1) survives as the time-scaling constant (`_SCALE`, seconds→µs);
trick (2) is provided as :func:`approx_inverse` for irregular-hardware
extensions but is not needed on the regular grids evaluated here (all
denominators are constants). The MILP is solved by HiGHS through
``scipy.optimize.milp`` with the paper's wall-clock budget.

The EDP objective (a product of two end-to-end sums) is handled — as the
paper observes, imperfectly — via an ε-constraint sweep on linearized
energy, re-scored exactly afterwards.

Two solver *engines* sit behind :func:`run_miqp` (DESIGN.md §12):

  * ``engine="milp"`` — this module: the linearized program above,
    handed to HiGHS one instance at a time under ``cfg.time_limit``.
    Kept as the Sec.-6.3 reference/audit path (it can *prove* model
    optimality, which the enumeration engine cannot certify once its
    candidate caps bind).
  * ``engine="lattice"`` — :mod:`.miqp_lattice`: the same
    observation taken to its conclusion. Every choice binary above is
    one cell of a small finite lattice, so instead of relaxing the
    products we materialize candidate schedules as genome tensors and
    arg-min the **exact** evaluator over them in batched chunks (on the
    card through the torch evaluator) — EDP scored directly (no
    ε-sweep).
  * ``engine="auto"`` (the default) resolves like ``backend="auto"``
    (:func:`resolve_auto_engine`): it picks ``"lattice"`` — measured
    ≥5× faster end-to-end and never worse on every benchmarked grid
    (``benchmarks/artifacts/miqp_solve.json``); select ``"milp"``
    explicitly when you need HiGHS's optimality certificate.

The port's copy of the JAX package's ``core/miqp.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
from scipy.optimize import Bounds, LinearConstraint, milp

from .evaluator import DEVICE_MODES  # noqa: F401 (re-exported)
from .evaluator import EvalOptions, Evaluator
from .hw import HWConfig, MCMType
from .workload import (Partition, Task, partition_domain,
                       uniform_partition)

__all__ = ["DEVICE_MODES", "ENGINES", "MIQPConfig", "MIQPResult",
           "run_miqp", "approx_inverse", "resolve_auto_engine"]

_SCALE = 1e6  # model time in microseconds (paper trick #1: constant scaling)

#: Solver engines behind :func:`run_miqp` (DESIGN.md §12).
ENGINES = ("milp", "lattice", "auto")


def approx_inverse(c, x):
    """Paper Sec. 6.3.1 trick #2: 1/(c+x) ≈ (c−x)/c² near x≈0.

    Accepts scalars or (numpy/torch) arrays for both arguments — the
    irregular-hardware extension feeds arrays of variable denominators
    — and stays a pure arithmetic expression. Relative error is exactly
    ``(x/c)²``."""
    return (c - x) / (c * c)


def resolve_auto_engine(engine: str) -> str:
    """Resolve ``"auto"`` to a concrete solver engine, mirroring
    :func:`.evaluator.resolve_auto_backend`. Auto picks
    ``"lattice"``: on the Sec.-6.2 search space it scores the exact
    evaluator (no linearization gap, EDP direct) and measured ≥5×
    faster than the HiGHS path on every benchmarked grid
    (DESIGN.md §12); ``"milp"`` stays available explicitly as the
    optimality-certificate reference."""
    if engine == "auto":
        return "lattice"
    if engine not in ("milp", "lattice"):
        raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
    return engine


@dataclasses.dataclass(frozen=True)
class MIQPConfig:
    slack: int = 2
    time_limit: float = 240.0     # paper: ~4 minutes average (milp engine)
    mip_rel_gap: float = 1e-3
    edp_sweep: int = 5            # ε-constraint points (milp EDP objective)
    # ---- engine selection (DESIGN.md §12) -------------------------------
    engine: str = "auto"          # "milp" | "lattice" | "auto" (→ lattice)
    # ---- lattice-engine knobs (ignored by the milp engine) --------------
    # All lattice budgets are *deterministic* candidate counts, not
    # wall-clock: a point's result is identical whether it is solved
    # alone or batched inside a sweep group (the §9 cache invariant).
    backend: str = "auto"         # scoring backend: "numpy"|"torch"|"auto"
    device: str | None = None     # torch scoring device (None: the card)
    candidate_budget: int = 65536  # exact-mode ceiling on the joint lattice
    eval_budget: int = 120_000    # beam-mode scoring budget (genomes)
    beam_width: int = 8           # beam assignments kept per layer pass
    refine_sweeps: int = 2        # width-1 coordinate-descent passes
    pair_refine: int = 48         # joint chained-pair re-scan: top-k²
    descent_sweeps: int = 10      # unit/swap local-search passes
    max_axis_candidates: int = 512   # per-op per-axis enumeration cap
    max_layer_candidates: int = 1024  # per-op (rows × cols) cap
    score_chunk: int = 2048       # fixed scoring-chunk shape (compile key)
    devices: str = "auto"         # grid-axis execution of the chunked
                                  # scoring calls: "single" | "sharded" |
                                  # "auto" (§15; result-neutral)


@dataclasses.dataclass
class MIQPResult:
    partition: Partition
    redist_mask: np.ndarray
    objective: float              # exact re-evaluated objective
    milp_status: str
    milp_objective: float         # model objective (µs) — diagnostics; the
                                  # lattice engine's model IS the exact
                                  # evaluator, so it reports objective·1e6
                                  # for latency and −1.0 otherwise
    engine: str = "milp"          # which engine produced this result


class _LP:
    """Tiny incremental MILP builder over scipy/HiGHS."""

    def __init__(self):
        self.nv = 0
        self.cost: list[float] = []
        self.lb: list[float] = []
        self.ub: list[float] = []
        self.integer: list[bool] = []
        self.rows: list[tuple[list[int], list[float], float, float]] = []

    def var(self, lb=0.0, ub=np.inf, integer=False, cost=0.0) -> int:
        self.cost.append(cost)
        self.lb.append(lb)
        self.ub.append(ub)
        self.integer.append(integer)
        self.nv += 1
        return self.nv - 1

    def vars(self, n, **kw) -> list[int]:
        return [self.var(**kw) for _ in range(n)]

    def con(self, idx: list[int], coef: list[float], lo: float, hi: float):
        self.rows.append((idx, coef, lo, hi))

    def solve(self, time_limit: float, mip_rel_gap: float):
        data, ri, ci = [], [], []
        clo, chi = [], []
        for r, (idx, coef, lo, hi) in enumerate(self.rows):
            for j, a in zip(idx, coef):
                ri.append(r)
                ci.append(j)
                data.append(a)
            clo.append(lo)
            chi.append(hi)
        A = sp.csr_matrix((data, (ri, ci)), shape=(len(self.rows), self.nv))
        res = milp(
            c=np.array(self.cost),
            constraints=LinearConstraint(A, np.array(clo), np.array(chi)),
            integrality=np.array(self.integer, dtype=int),
            bounds=Bounds(np.array(self.lb), np.array(self.ub)),
            options={"time_limit": time_limit, "mip_rel_gap": mip_rel_gap,
                     "presolve": True},
        )
        return res


def _choice_vals(lo: int, hi: int) -> np.ndarray:
    return np.arange(lo, hi + 1)


def run_miqp(
    task: Task,
    hw: HWConfig,
    objective: str = "latency",
    options: EvalOptions | None = None,
    cfg: MIQPConfig = MIQPConfig(),
    engine: str | None = None,
) -> MIQPResult:
    """Solve for partitions; redistribution decisions follow the fixed
    strategy of Sec. 6.1 (all semantically-valid chained pairs when the
    evaluator options enable redistribution).

    ``engine`` overrides ``cfg.engine`` (DESIGN.md §12): ``"milp"`` is
    the HiGHS program below, ``"lattice"`` the batched exact-enumeration
    engine (:mod:`.miqp_lattice`), ``"auto"``/``None`` resolves via
    :func:`resolve_auto_engine`. The lattice engine additionally accepts
    ``objective="energy"``."""
    if options is None:
        options = EvalOptions(redistribution=True, async_exec=False)
    if resolve_auto_engine(engine or cfg.engine) == "lattice":
        from . import miqp_lattice

        return miqp_lattice.solve_lattice_batch(
            [task], [hw], options, objective, cfg)[0]
    if hw.is_hetero:
        # The HiGHS formulation linearizes against the package-scalar
        # rates; per-chiplet rates need the lattice engine, which scores
        # through the (hetero-exact) evaluator constants.
        raise ValueError(
            "engine='milp' models homogeneous grids only; use "
            "engine='lattice' for heterogeneous chiplet classes")
    ev = Evaluator(task, hw, options)
    if objective == "latency":
        try:
            x, status, mobj = _solve_once(task, hw, ev, cfg,
                                          energy_cap=None)
            part, rd = _decode(task, hw, ev, cfg, x)
        except _Infeasible as e:
            # solver hit its budget with no incumbent (large instances):
            # fall back to the uniform partition — downstream polish still
            # improves collectors/placement, and the result is reported
            # honestly as a timeout fallback.
            part = uniform_partition(task, hw.X, hw.Y)
            rd = ev.chain_valid & ev.opts.redistribution
            exact = ev.evaluate(part, rd).latency
            return MIQPResult(part, rd, exact, f"fallback: {e}", -1.0)
        exact = ev.evaluate(part, rd).latency
        return MIQPResult(part, rd, exact, status, mobj)
    if objective == "edp":
        # ε-constraint sweep on linearized energy; exact re-scoring.
        try:
            x0, status, mobj = _solve_once(task, hw, ev, cfg,
                                           energy_cap=None)
            part0, rd0 = _decode(task, hw, ev, cfg, x0)
        except _Infeasible as e:
            part0 = uniform_partition(task, hw.X, hw.Y)
            rd0 = ev.chain_valid & ev.opts.redistribution
            base0 = ev.evaluate(part0, rd0)
            return MIQPResult(part0, rd0, base0.edp,
                              f"fallback: {e}", -1.0)
        base = ev.evaluate(part0, rd0)
        best = (base.edp, part0, rd0, status, mobj)
        e_lo, e_hi = 0.55 * base.energy, 1.0 * base.energy
        for cap in np.geomspace(e_lo, e_hi, cfg.edp_sweep):
            try:
                x, st, mo = _solve_once(
                    task, hw, ev, cfg, energy_cap=float(cap),
                    time_limit=cfg.time_limit / cfg.edp_sweep)
            except _Infeasible:
                continue
            p, rd = _decode(task, hw, ev, cfg, x)
            r = ev.evaluate(p, rd)
            if r.edp < best[0]:
                best = (r.edp, p, rd, st, mo)
        return MIQPResult(best[1], best[2], best[0], best[3], best[4])
    raise ValueError(f"unknown objective {objective}")


class _Infeasible(RuntimeError):
    pass


def _solve_once(task, hw, ev, cfg, energy_cap=None, time_limit=None):
    lp, handles = _formulate(task, hw, ev, cfg, energy_cap)
    res = lp.solve(time_limit or cfg.time_limit, cfg.mip_rel_gap)
    if res.x is None:
        raise _Infeasible(f"MILP failed: {res.message}")
    return res.x, res.message, float(res.fun)


# --------------------------------------------------------------------------
# Formulation
# --------------------------------------------------------------------------
def _formulate(task: Task, hw: HWConfig, ev: Evaluator, cfg: MIQPConfig,
               energy_cap: float | None):
    lp = _LP()
    n = len(task)
    X, Y = hw.X, hw.Y
    R, C = hw.R, hw.C
    B = ev.B
    bw_nop, bw_ent, freq = ev.bw_nop, ev.bw_ent, ev.freq
    top = ev.top
    lo, hi = partition_domain(task, X, Y, R, C, cfg.slack)
    redist = ev.chain_valid & ev.opts.redistribution
    keepA = np.concatenate([[1.0], 1.0 - redist[:-1].astype(float)])
    c_fix = Y // 2  # fixed collector column (GA optimizes it; MIQP fixes it)

    M, K, N = ev.M, ev.K, ev.N
    Mu = np.ceil(M / R).astype(int)
    Nu = np.ceil(N / C).astype(int)
    fill = 2.0 * R + C + K - 2.0
    cyc_coef = (fill + ev.epilogue * R)  # cycles per (u·v) unit product

    S = _SCALE
    z = {}   # (i,x) -> (vals, [var ids])
    w = {}
    mxz = {}
    myz = {}
    energy_terms: list[tuple[int, float]] = []   # linear energy expr
    energy_const = 0.0

    for i in range(n):
        vx = _choice_vals(lo[i, 0], hi[i, 0])
        vy = _choice_vals(lo[i, 1], hi[i, 1])
        for x in range(X):
            ids = lp.vars(len(vx), lb=0, ub=1, integer=True)
            lp.con(ids, [1.0] * len(ids), 1.0, 1.0)          # one-hot
            z[i, x] = (vx, ids)
        for y in range(Y):
            ids = lp.vars(len(vy), lb=0, ub=1, integer=True)
            lp.con(ids, [1.0] * len(ids), 1.0, 1.0)
            w[i, y] = (vy, ids)
        # partition sums (padded to R/C units)
        idx = [j for x in range(X) for j in z[i, x][1]]
        coef = [float(a) for x in range(X) for a in z[i, x][0]]
        lp.con(idx, coef, float(Mu[i]), float(Mu[i]))
        idx = [j for y in range(Y) for j in w[i, y][1]]
        coef = [float(b) for y in range(Y) for b in w[i, y][0]]
        lp.con(idx, coef, float(Nu[i]), float(Nu[i]))
        # max-selection one-hots
        mx_ids = lp.vars(len(vx), lb=0, ub=1, integer=True)
        lp.con(mx_ids, [1.0] * len(mx_ids), 1.0, 1.0)
        my_ids = lp.vars(len(vy), lb=0, ub=1, integer=True)
        lp.con(my_ids, [1.0] * len(my_ids), 1.0, 1.0)
        mxz[i] = (vx, mx_ids)
        myz[i] = (vy, my_ids)
        # mx ≥ u[i,x] ∀x  (objective pressure sets mx = max_x u)
        for x in range(X):
            vals, ids = z[i, x]
            lp.con(mx_ids + ids,
                   [float(a) for a in vx] + [-float(a) for a in vals],
                   0.0, np.inf)
        for y in range(Y):
            vals, ids = w[i, y]
            lp.con(my_ids + ids,
                   [float(b) for b in vy] + [-float(b) for b in vals],
                   0.0, np.inf)

    def u_expr(i, x, scale=1.0):
        vals, ids = z[i, x]
        return ids, [scale * float(a) for a in vals]

    def v_expr(i, y, scale=1.0):
        vals, ids = w[i, y]
        return ids, [scale * float(b) for b in vals]

    total_cost_vars = []

    for i in range(n):
        vx, mx_ids = mxz[i]
        vy, my_ids = myz[i]

        # ------------------------------------------------ t_in (epigraph)
        tin = lp.var(cost=1.0)
        total_cost_vars.append(tin)
        #   off-chip per entrance
        for e in range(top.n_entrances):
            idx, coef = [tin], [1.0]
            for x in range(X):
                if ev.row_mask[e, x] and keepA[i] > 0:
                    ii, cc = u_expr(i, x, -S * keepA[i] * R * K[i] * B
                                    / bw_ent)
                    idx += ii
                    coef += cc
            for y in range(Y):
                if ev.col_mask[e, y]:
                    ii, cc = v_expr(
                        i, y, -S * C * K[i] * ev.w_scale[i] * B / bw_ent)
                    idx += ii
                    coef += cc
            lp.con(idx, coef, 0.0, np.inf)
        #   NoP distribution per chiplet
        for x in range(X):
            for y in range(Y):
                hA = ev.hA[x, y]
                hWv = ev.hW[x, y]
                idx, coef = [tin], [1.0]
                if keepA[i] > 0 and hA > 0:
                    ii, cc = u_expr(i, x, -S * keepA[i] * R * K[i] * B * hA
                                    / bw_nop)
                    idx += ii
                    coef += cc
                if hWv > 0:
                    ii, cc = v_expr(
                        i, y,
                        -S * C * K[i] * ev.w_scale[i] * B * hWv / bw_nop)
                    idx += ii
                    coef += cc
                if len(idx) > 1:
                    lp.con(idx, coef, 0.0, np.inf)

        # ------------------------------------------------ t_comp via q
        tcomp = lp.var(cost=1.0)
        total_cost_vars.append(tcomp)
        q_ids = []
        q_vals = []
        for a, va in enumerate(vx):
            for b, vb in enumerate(vy):
                qv = lp.var(lb=0.0, ub=1.0)
                lp.con([qv, mx_ids[a], my_ids[b]], [1.0, -1.0, -1.0],
                       -1.0, np.inf)
                q_ids.append(qv)
                q_vals.append(float(va * vb))
        lp.con([tcomp] + q_ids,
               [1.0] + [-S * cyc_coef[i] * v / freq for v in q_vals],
               0.0, np.inf)
        # E_mac (paper mode): e_mac·maxcyc·R·C·XY
        for qv, val in zip(q_ids, q_vals):
            energy_terms.append(
                (qv, hw.e_mac_cycle * cyc_coef[i] * val * R * C * X * Y))

        # ------------------------------------------------ t_out
        if redist[i]:
            # Step 1: row gather, exact McCormick (choice × affine).
            t1 = lp.var(cost=1.0)
            total_cost_vars.append(t1)
            Lmax = float(sum(C * hi[i, 1] for y in range(Y) if y < c_fix))
            Rmax = float(sum(C * hi[i, 1] for y in range(Y) if y > c_fix))
            for x in range(X):
                vals, ids = z[i, x]
                for side, mx_side in (("L", Lmax), ("R", Rmax)):
                    if mx_side <= 0:
                        continue
                    g_ids = []
                    for a, va in enumerate(vals):
                        g = lp.var(lb=0.0)
                        # g ≥ Sv − Smax(1−z)
                        sv_idx, sv_coef = [], []
                        for y in range(Y):
                            if (y < c_fix) if side == "L" else (y > c_fix):
                                ii, cc = v_expr(i, y, float(C))
                                sv_idx += ii
                                sv_coef += cc
                        lp.con([g, ids[a]] + sv_idx,
                               [1.0, -mx_side] + [-c for c in sv_coef],
                               -mx_side, np.inf)
                        g_ids.append((g, float(va)))
                    # t1 ≥ R·B/bw · Σ va·g
                    lp.con([t1] + [g for g, _ in g_ids],
                           [1.0] + [-S * R * B * va / bw_nop
                                    for _, va in g_ids],
                           0.0, np.inf)
            # Step 2: broadcast — t2 = mx·R·N·B/bw (linear in mx one-hot).
            t2 = lp.var(cost=1.0)
            total_cost_vars.append(t2)
            lp.con([t2] + mx_ids,
                   [1.0] + [-S * float(a) * R * N[i] * B / bw_nop
                            for a in vx],
                   0.0, np.inf)
            # Step 3: |cumfrac(Px_i) − cumfrac(Px_{i+1})| column shuffles
            # (normalized fractions — consecutive-op row counts may differ).
            t3 = lp.var(cost=1.0)
            total_cost_vars.append(t3)
            for x in range(X - 1):
                d = lp.var(lb=0.0)   # crossing fraction at boundary x
                idx, coef = [d], [1.0]
                for xx in range(x + 1):
                    ii, cc = u_expr(i, xx, -float(R) / M[i])
                    idx += ii
                    coef += cc
                    ii, cc = u_expr(i + 1, xx, float(R) / M[i + 1])
                    idx += ii
                    coef += cc
                lp.con(idx, coef, 0.0, np.inf)
                lp.con(idx, [1.0] + [-c for c in coef[1:]], 0.0, np.inf)
                lp.con([t3, d], [1.0, -S * M[i] * N[i] * B / bw_nop],
                       0.0, np.inf)
                energy_terms.append(
                    (d, hw.e_nop_bit_hop * 8.0 * M[i] * N[i] * B * Y))
            # redistribution energy (gather+broadcast, uniform-col approx)
            for x in range(X):
                ii, cc = u_expr(i, x, 1.0)
                for j, c0 in zip(ii, cc):
                    energy_terms.append(
                        (j, c0 * R * N[i] * B * hw.e_nop_bit_hop * 8.0
                         * max(Y - 1, 1)))
        else:
            tout = lp.var(cost=1.0)
            total_cost_vars.append(tout)
            t = hw.mcm_type
            if t == MCMType.A:
                links = float(top.entrance_links[0])
                const = M[i] * N[i] * B
                lp.con([tout], [1.0], S * const / (links * bw_nop), np.inf)
                lp.con([tout], [1.0], S * const / bw_ent, np.inf)
            elif t == MCMType.B:
                # strip groups: out_e = Px[x_e]·(Σ_{y∈e} Py)·B, exact
                # binary-McCormick.
                for e in range(top.n_entrances):
                    xs = np.where(ev.row_mask[e])[0]
                    ys = np.where(ev.col_mask[e])[0]
                    if len(xs) != 1:
                        continue
                    x_e = int(xs[0])
                    vals, ids = z[i, x_e]
                    Smax = float(C * hi[i, 1] * len(ys))
                    g_ids = []
                    for a, va in enumerate(vals):
                        g = lp.var(lb=0.0)
                        sv_idx, sv_coef = [], []
                        for y in ys:
                            ii, cc = v_expr(i, int(y), float(C))
                            sv_idx += ii
                            sv_coef += cc
                        lp.con([g, ids[a]] + sv_idx,
                               [1.0, -Smax] + [-c for c in sv_coef],
                               -Smax, np.inf)
                        g_ids.append((g, float(va)))
                    links = float(max(top.entrance_links[e], 1))
                    for denom in (links * bw_nop, bw_ent):
                        lp.con([tout] + [g for g, _ in g_ids],
                               [1.0] + [-S * R * B * va / denom
                                        for _, va in g_ids],
                               0.0, np.inf)
            elif t == MCMType.C:
                # per-chiplet 3D offload: max chunk / bw_ent = R·C·mx·my/bw.
                lp.con([tout] + q_ids,
                       [1.0] + [-S * R * C * B * v / bw_ent for v in q_vals],
                       0.0, np.inf)
            else:
                # Type D: conservative bound — groupsize · maxchunk.
                gs = float(top.group_size.max())
                links = float(max(top.entrance_links.min(), 1))
                for denom in (links * bw_nop, bw_ent):
                    lp.con([tout] + q_ids,
                           [1.0] + [-S * gs * R * C * B * v / denom
                                    for v in q_vals],
                           0.0, np.inf)
            # offload memory-write energy
            energy_const += hw.e_mem_bit * 8.0 * M[i] * N[i] * B

        # ------------------------------------------------ t_sync
        if ev.sync[i]:
            tsy = lp.var(cost=1.0)
            total_cost_vars.append(tsy)
            lp.con([tsy] + mx_ids,
                   [1.0] + [-S * float(a) * R * 4.0 * B * max(Y - 1, 1)
                            / bw_nop for a in vx],
                   0.0, np.inf)

        # ------------------------------------------------ linear energy
        # SRAM + memory pulls + NoP loads (collection uses uniform-col
        # approximation for the hop-weighted sum — energy only).
        for x in range(X):
            ii, cc = u_expr(i, x, 1.0)
            coef = (hw.e_sram_bit * 8.0 * Y * R * K[i] * B
                    + keepA[i] * hw.e_mem_bit * 8.0
                    * float(ev.row_mask[:, x].sum()) * R * K[i] * B
                    + keepA[i] * hw.e_nop_bit_hop * 8.0 * R * K[i] * B
                    * float(ev.hA[x].sum()))
            if not redist[i]:
                coef += (hw.e_nop_bit_hop * 8.0 * R * (N[i] / Y) * B
                         * float(ev.h_min[x].sum()))
            for j, c0 in zip(ii, cc):
                energy_terms.append((j, c0 * coef))
        for y in range(Y):
            ii, cc = v_expr(i, y, 1.0)
            coef = (hw.e_sram_bit * 8.0 * X * C * K[i] * ev.w_scale[i] * B
                    + hw.e_mem_bit * 8.0 * float(ev.col_mask[:, y].sum())
                    * C * K[i] * ev.w_scale[i] * B
                    + hw.e_nop_bit_hop * 8.0 * C * K[i] * ev.w_scale[i] * B
                    * float(ev.hW[:, y].sum()))
            for j, c0 in zip(ii, cc):
                energy_terms.append((j, c0 * coef))
        energy_const += hw.e_sram_bit * 8.0 * M[i] * N[i] * B

    if energy_cap is not None:
        idx = [j for j, _ in energy_terms]
        coef = [c for _, c in energy_terms]
        lp.con(idx, coef, -np.inf, float(energy_cap - energy_const))

    return lp, {"z": z, "w": w, "lo": lo, "hi": hi}


def _unpad_rows(vals: np.ndarray, total: int) -> np.ndarray:
    """Un-pad candidate rows to exact sums: the solvers work on R/C-unit
    counts whose padded sums are ``ceil(M/R)·R ≥ M``; the residue comes
    off each row's largest entry (spilling to a neighbour if that entry
    would go negative). Shared by the MILP decode and the lattice
    engine's candidate materialization so both engines land in the same
    actual-partition space (DESIGN.md §12)."""
    arr = np.atleast_2d(np.asarray(vals, dtype=np.int64)).copy()
    d = arr.sum(axis=1) - int(total)
    rows = np.arange(len(arr))
    k = np.argmax(arr, axis=1)
    arr[rows, k] -= d
    for r in np.where(arr[rows, k] < 0)[0]:
        kk = int(k[r])
        j = kk + 1 if kk + 1 < arr.shape[1] else kk - 1
        arr[r, j] += arr[r, kk]
        arr[r, kk] = 0
    return arr


def _decode(task, hw, ev, cfg, x) -> tuple[Partition, np.ndarray]:
    lp, handles = _formulate(task, hw, ev, cfg, None)
    # Rebuild the variable layout deterministically to decode: instead of
    # re-solving, we track z/w ids from the handles of this formulation —
    # they match the solved vector because _formulate is deterministic.
    z, w = handles["z"], handles["w"]
    n = len(task)
    X, Y = hw.X, hw.Y
    Px = np.zeros((n, X), dtype=np.int64)
    Py = np.zeros((n, Y), dtype=np.int64)
    for i in range(n):
        for xx in range(X):
            vals, ids = z[i, xx]
            sel = int(np.argmax([x[j] for j in ids]))
            Px[i, xx] = int(vals[sel]) * hw.R
        for yy in range(Y):
            vals, ids = w[i, yy]
            sel = int(np.argmax([x[j] for j in ids]))
            Py[i, yy] = int(vals[sel]) * hw.C
        # un-pad to exact sums
        Px[i] = _unpad_rows(Px[i], task.ops[i].M)[0]
        Py[i] = _unpad_rows(Py[i], task.ops[i].N)[0]
    coll = np.full(n, hw.Y // 2, dtype=np.int64)
    part = Partition(Px, Py, coll)
    part.validate(task)
    rd = ev.chain_valid & ev.opts.redistribution
    return part, rd
