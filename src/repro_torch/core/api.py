"""Public entry points for the MCMComm core — the four scheduling schemes
of the paper's Table 3 behind one call, plus pipelining.

>>> from repro_torch.core import api
>>> res = api.optimize(task, hw, method="miqp", objective="latency")
>>> res.latency, res.speedup_vs_baseline

The port's copy of the JAX package's ``core/api.py``, with
:func:`cosearch`, the fused joint search. The torch evaluator runs on
``device`` (``None`` means the card, and raises without one).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from .evaluator import (EvalOptions, EvalResult, Evaluator,
                        resolve_auto_backend)
from .ga import GAConfig, run_ga
from .hw import HWConfig
from .miqp import MIQPConfig, run_miqp
from .pipelining import PipelineConfig, PipelineResult, pipeline_batch
from .simba import simba_partition
from .sweep import EvalPoint, eval_sweep
from .workload import Partition, Task, uniform_partition

__all__ = ["ScheduleResult", "optimize", "baseline_result",
           "refine_schedule", "cosearch", "METHODS"]

METHODS = ("baseline", "simba", "ga", "miqp")


@dataclasses.dataclass
class ScheduleResult:
    method: str
    objective: str
    partition: Partition
    redist_mask: np.ndarray
    eval: EvalResult
    baseline: EvalResult
    solve_seconds: float
    # Evaluation context (DESIGN.md §13): the task, the *actual* hw the
    # schedule was scored on (optimize() toggles diagonal links per
    # method), the EvalOptions used, and the scoring backend and device —
    # what segments() needs to re-derive per-op durations under a
    # different congestion model.
    task: Task | None = None
    hw_used: HWConfig | None = None
    options: EvalOptions | None = None
    backend: str = "numpy"
    device: object = None

    @property
    def latency(self) -> float:
        return self.eval.latency

    @property
    def edp(self) -> float:
        return self.eval.edp

    @property
    def speedup_vs_baseline(self) -> float:
        if self.objective == "edp":
            return self.baseline.edp / self.eval.edp
        return self.baseline.latency / self.eval.latency

    def segments(self, congestion: str | None = None
                 ) -> list[tuple[str, float, float, float]]:
        """Per-op ``(name, t_in, t_comp, t_out)`` durations of this
        schedule for the RCPSP pipeliner (Sec. 5.4 / DESIGN.md §13).

        ``congestion`` re-scores the schedule under a different
        congestion model (DESIGN.md §11) — ``"flow"`` makes the segment
        durations come from simulated netsim arrival times instead of
        the closed-form regime pick. Routed through the cached
        :func:`.sweep.eval_sweep` on the schedule's ``backend`` and
        ``device``, so repeated pipelining studies on one schedule
        evaluate it once per congestion mode."""
        if congestion is None:
            return self.eval.segments()
        if self.options is None:
            # Construction without the context fields must not silently
            # return wrong-congestion durations.
            raise ValueError(
                "congestion-aware segments need the evaluation context "
                "(task/hw_used/options) — construct the ScheduleResult "
                "via optimize()")
        if congestion == self.options.congestion:
            return self.eval.segments()
        opts = dataclasses.replace(self.options, congestion=congestion)
        rec = eval_sweep([EvalPoint(self.task, self.hw_used, opts,
                                    self.partition, self.redist_mask)],
                         backend=self.backend, device=self.device)[0]
        return [(f"op{i}", float(rec["t_in"][i]), float(rec["t_comp"][i]),
                 float(rec["t_out"][i]))
                for i in range(len(rec["t_in"]))]

    def pipeline(self, batch: int, use_milp: bool = False,
                 config: PipelineConfig | None = None,
                 congestion: str | None = None) -> PipelineResult:
        """Cross-sample pipelining of this schedule (Sec. 5.4).

        ``config`` selects the scheduler engine (DESIGN.md §13);
        ``congestion="flow"`` derives the segment durations from netsim
        arrival times (see :meth:`segments`). Batched (workload × batch)
        grids should go through :func:`.sweep.pipeline_sweep`
        instead."""
        return pipeline_batch(self.segments(congestion), batch,
                              use_milp=use_milp, config=config)


def _polish(task: Task, hw: HWConfig, opts: EvalOptions, part: Partition,
            rd: np.ndarray, objective: str, rounds: int = 2,
            backend: str = "numpy", device=None
            ) -> tuple[Partition, np.ndarray]:
    """Coordinate descent on variables MIQP keeps fixed or cannot see:
    collector columns, per-pair redistribution bits, and *placement* of the
    per-row/column shares. The MIQP solve uses the paper's sync
    approximation (max() per comm/comp pair), which is blind to which
    chiplet row carries which share — under fused (async) execution the
    busiest-compute row should sit nearest the entrance. Reordering a
    partition vector is sum-preserving, so these moves stay feasible."""
    ev = Evaluator(task, hw, opts, backend=backend, device=device)
    key = "edp" if objective == "edp" else "latency"

    def score(p, m):
        return getattr(ev.evaluate(p, m), key)

    best = score(part, rd)
    part = part.copy()
    rd = rd.copy()
    n = len(task)
    for _ in range(rounds):
        improved = False
        for i in range(n):
            # placement polish: try monotone orderings of the shares
            for arr in (part.Px[i], part.Py[i]):
                cur = arr.copy()
                for cand in (np.sort(cur)[::-1], np.sort(cur), cur[::-1]):
                    arr[:] = cand
                    s = score(part, rd)
                    if s < best - 1e-18:
                        best = s
                        cur = arr.copy()
                        improved = True
                    else:
                        arr[:] = cur
            if rd[i]:
                for c in range(hw.Y):
                    if c == part.collectors[i]:
                        continue
                    old = part.collectors[i]
                    part.collectors[i] = c
                    s = score(part, rd)
                    if s < best:
                        best = s
                        improved = True
                    else:
                        part.collectors[i] = old
            if ev.chain_valid[i]:
                rd[i] = not rd[i]
                s = score(part, rd)
                if s < best:
                    best = s
                    improved = True
                else:
                    rd[i] = not rd[i]
        if not improved:
            break
    return part, rd


def refine_schedule(task: Task, hw: HWConfig, options: EvalOptions,
                    partition: Partition, redist_mask: np.ndarray,
                    objective: str = "latency", backend: str = "numpy",
                    rounds: int = 2, device=None
                    ) -> tuple[Partition, np.ndarray]:
    """Public wrapper around the MIQP side-variable polish: exact-
    evaluator coordinate descent on collector columns, per-pair
    redistribution bits, and share placement — the variables both MIQP
    engines fix during the solve (DESIGN.md §6/§12)."""
    return _polish(task, hw, options, partition, redist_mask, objective,
                   rounds=rounds, backend=backend, device=device)


def baseline_result(task: Task, hw: HWConfig,
                    backend: str = "numpy", device=None) -> EvalResult:
    """Layer-Sequential baseline: uniform partitioning, no optimizations
    (Table 3 row 1). Evaluated on the plain mesh (no diagonal links).

    Routed through :mod:`.sweep` so repeated baselines — every
    ``optimize`` call scores against one — are evaluated once per
    process (DESIGN.md §9)."""
    hw0 = hw.replace(diagonal_links=False)
    rec = eval_sweep([EvalPoint(task, hw0)], backend=backend,
                     device=device)[0]
    return EvalResult(
        latency=rec["latency"], energy=rec["energy"], edp=rec["edp"],
        t_in=rec["t_in"], t_comp=rec["t_comp"], t_out=rec["t_out"],
        redist=np.zeros(len(task), dtype=bool),
    )


def optimize(
    task: Task,
    hw: HWConfig,
    method: str = "miqp",
    objective: str = "latency",
    options: EvalOptions | None = None,
    ga_config: GAConfig | None = None,
    miqp_config: MIQPConfig | None = None,
    backend: str | None = None,
    device=None,
) -> ScheduleResult:
    """Run one scheduling scheme of Table 3 and score it against the LS
    baseline. ``ga``/``miqp`` enable the co-optimizations (diagonal links
    + redistribution; GA additionally uses async fusion); ``baseline`` and
    ``simba`` run without them, as in the paper's methodology.

    ``backend`` selects the evaluator engine (DESIGN.md §8) for the GA
    fitness loop, the baseline, and every scoring/polish pass; backends
    agree to float64 round-off (rtol 1e-9; identical GA trajectories
    under a fixed seed on CPU). ``None`` means numpy, except the ``ga``
    branch which follows ``ga_config.backend`` end-to-end (fitness and
    scoring always use the same engine); ``ga_config.engine="vectorized"``
    on the torch backend runs the GA's device engine (:mod:`.ga_torch`),
    the whole search on the card. ``"auto"`` resolves by the GA
    population size (torch at ≥1024, DESIGN.md §8).
    ``miqp_config.engine`` likewise selects the MIQP solver engine
    (DESIGN.md §12): ``"milp"`` = the HiGHS program, ``"lattice"`` (the
    ``"auto"`` default) = batched exact enumeration of the Sec.-6.2
    search lattice, scored by the chosen evaluator backend — with the
    default ``MIQPConfig(backend="auto")``, by the torch evaluator.

    ``device`` is where the torch evaluator runs (``None``: the card,
    raising without one; ``"cpu"`` runs it on the host); it also fills
    ``ga_config.device`` and ``miqp_config.device``."""
    scoring_backend = resolve_auto_backend(backend or "numpy", 1)
    base = baseline_result(task, hw, backend=scoring_backend, device=device)
    t0 = time.perf_counter()
    if method == "baseline":
        hw_used = hw.replace(diagonal_links=False)
        opts = EvalOptions()
        part = uniform_partition(task, hw.X, hw.Y)
        ev = Evaluator(task, hw_used, opts, backend=scoring_backend,
                       device=device)
        res = ev.evaluate(part)
        rd = np.zeros(len(task), dtype=bool)
    elif method == "simba":
        hw_used = hw.replace(diagonal_links=False)
        opts = EvalOptions()
        part = simba_partition(task, hw_used)
        ev = Evaluator(task, hw_used, opts, backend=scoring_backend,
                       device=device)
        res = ev.evaluate(part)
        rd = np.zeros(len(task), dtype=bool)
    elif method == "ga":
        opts = options or EvalOptions(redistribution=True, async_exec=True)
        hw_used = hw.replace(diagonal_links=True)
        cfg = ga_config or GAConfig()
        if device is not None:
            cfg = dataclasses.replace(cfg, device=device)
        # Score with the engine the GA fitness actually ran on, so a
        # GAConfig(backend="torch") caller never silently mixes engines.
        ga_backend = resolve_auto_backend(backend or cfg.backend,
                                          cfg.population)
        scoring_backend = ga_backend
        out = run_ga(task, hw_used, objective, opts, cfg,
                     backend=ga_backend)
        part, rd = out.partition, out.redist_mask
        res = Evaluator(task, hw_used, opts, backend=ga_backend,
                        device=cfg.device).evaluate(part, rd)
    elif method == "miqp":
        # Solve under the paper's sync approximation (Sec. 6.3.2 adds max()
        # sync per comm/comp pair), then score the resulting partition under
        # the full runtime (same options as GA) and polish the discrete
        # side-variables (collectors, redistribution bits) with the exact
        # evaluator — MIQP fixes those during the solve. Both engines
        # (HiGHS milp / batched lattice, DESIGN.md §12) run the same
        # solve→polish→score pipeline; ``miqp_config.engine`` selects
        # (default "auto" → lattice), and an explicit ``backend`` also
        # drives the lattice engine's scoring chunks.
        solve_opts = EvalOptions(redistribution=True, async_exec=False)
        opts = options or EvalOptions(redistribution=True, async_exec=True)
        hw_used = hw.replace(diagonal_links=True)
        mcfg = miqp_config or MIQPConfig()
        if backend is not None:
            mcfg = dataclasses.replace(mcfg, backend=backend)
        if device is not None:
            mcfg = dataclasses.replace(mcfg, device=device)
        out = run_miqp(task, hw_used, objective, solve_opts, mcfg)
        part, rd = out.partition, out.redist_mask
        part, rd = _polish(task, hw_used, opts, part, rd, objective,
                           backend=scoring_backend, device=device)
        res = Evaluator(task, hw_used, opts, backend=scoring_backend,
                        device=device).evaluate(part, rd)
    else:
        raise ValueError(f"unknown method {method!r}; one of {METHODS}")
    dt = time.perf_counter() - t0
    return ScheduleResult(method, objective, part, rd, res, base, dt,
                          task=task, hw_used=hw_used, options=opts,
                          backend=scoring_backend,
                          device=cfg.device if method == "ga" else device)


def cosearch(
    task: Task,
    hw: HWConfig,
    objective: str = "edp",
    options: EvalOptions | None = None,
    cfg=None,
    cache: bool = True,
    devices: str | None = None,
    device=None,
):
    """One-call front door for the fused joint search (DESIGN.md §16):
    partition × diagonal links × pipeline segmentation scored end to end
    in one fused fitness on the card. Returns a
    :class:`.cosearch.CoSearchResult` — the best genome on ``objective``
    plus the Pareto front over (EDP, latency, energy). Unlike
    :func:`optimize`, the link configuration is *part of the genome*
    (``hw.diagonal_links`` is ignored), and the pipeline schedule is
    searched jointly instead of refined afterwards.

    Routes through :func:`.sweep.cosearch_sweep`, so results land in
    (and are served from) the §9 cache under the ``"cosearch"`` method
    tag; ``cfg`` defaults to :class:`.cosearch.CoSearchConfig()`, and
    ``device`` (``None``: the config's, the card by default) is where
    it runs."""
    from .sweep import cosearch_sweep

    opts = options or EvalOptions(redistribution=True, async_exec=True)
    return cosearch_sweep([EvalPoint(task, hw, opts)], objective=objective,
                          cfg=cfg, cache=cache, devices=devices,
                          device=device)[0]
