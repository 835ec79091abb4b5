"""The paper's front door in the port (``repro_torch.core.api.optimize``
and what it runs: the workload graphs, SIMBA, the GA, both MIQP engines,
pipelining, the evaluation sweep and its cache) against the JAX
package's, on tasks and MCMs built in each package from the same
numbers. The JAX package runs on its numpy engines: its JAX backends
need ``jax.experimental.enable_x64``, which jax 0.9 lacks (ROADMAP.md).

Contracts: the port's numpy paths equal JAX's (partitions equal,
latency/EDP at rtol 1e-12); the lattice scored by the torch evaluator
on the CPU is held at rtol 1e-9 and, where mirrored share vectors tie,
to the tie contract: the partition equal, or else the port's partition,
re-scored by the JAX numpy evaluator, within rtol 1e-9 of the JAX
objective."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro import graphs as j_graphs
from repro.core import api as j_api
from repro.core import evaluator as j_ev
from repro.core import ga as j_ga
from repro.core import hw as j_hw
from repro.core import miqp as j_miqp
from repro.core import pipelining as j_pipe
from repro.core import simba as j_simba
from repro.core import sweep as j_sweep
from repro.core import workload as j_wl
from repro_torch import graphs as t_graphs
from repro_torch.core import api as t_api
from repro_torch.core import evaluator as t_ev
from repro_torch.core import evaluator_torch
from repro_torch.core import ga as t_ga
from repro_torch.core import hw as t_hw
from repro_torch.core import miqp as t_miqp
from repro_torch.core import miqp_lattice
from repro_torch.core import multitenant as t_mt
from repro_torch.core import pipelining as t_pipe
from repro_torch.core import simba as t_simba
from repro_torch.core import sweep as t_sweep
from repro_torch.core import workload as t_wl

EXACT = 1e-12
TORCH = 1e-9
# The front door's cases: AlexNet and ViT-B/16 cut to depth 2, on the
# quickstart's 4x4 type-A HBM package (the lattice in beam mode) and on a
# 2x2 type-C (3D) DRAM one (exact mode).
TASKS = {"alexnet": dict(), "vit2": dict(depth=2)}
HWS = {"A4hbm": ("A", 4, "hbm"), "C2dram": ("C", 2, "dram")}
# A short GA (same seed both sides): the trajectories must be identical.
GA = dict(population=24, generations=30, patience=10, seed=3)


def _task(pkg, name):
    graphs = j_graphs if pkg == "jax" else t_graphs
    key = "vit" if name.startswith("vit") else name
    return graphs.WORKLOADS[key](**TASKS.get(name, {}))


def _hw(pkg, key):
    return (j_hw if pkg == "jax" else t_hw).make_hw(*HWS[key])


@functools.lru_cache(maxsize=None)
def _optimize(pkg, task, hw, method, objective="latency", **kw):
    api, ga, miqp = ((j_api, j_ga, j_miqp) if pkg == "jax"
                     else (t_api, t_ga, t_miqp))
    mcfg = miqp.MIQPConfig(**dict(kw.pop("miqp", (("backend", "numpy"),))))
    return api.optimize(_task(pkg, task), _hw(pkg, hw), method, objective,
                        ga_config=ga.GAConfig(**GA), miqp_config=mcfg, **kw)


def _same_partition(a, b):
    return (np.array_equal(a.Px, b.Px) and np.array_equal(a.Py, b.Py)
            and np.array_equal(a.collectors, b.collectors))


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


# ---------------------------------------------------------------- graphs
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("name", sorted(j_graphs.WORKLOADS))
def test_graph_tasks_equal_jax(name, batch):
    want = j_graphs.WORKLOADS[name](batch=batch)
    got = t_graphs.WORKLOADS[name](batch=batch)
    assert got.name == want.name and len(got) == len(want)
    for g, w in zip(got.ops, want.ops):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
    assert got.total_flops == want.total_flops


@pytest.mark.parametrize("mcm", "ABCD")
@pytest.mark.parametrize("name", sorted(j_graphs.WORKLOADS))
def test_simba_partition_equal(name, mcm):
    want = j_simba.simba_partition(j_graphs.WORKLOADS[name](),
                                   j_hw.make_hw(mcm, 4, "hbm"))
    got = t_simba.simba_partition(t_graphs.WORKLOADS[name](),
                                  t_hw.make_hw(mcm, 4, "hbm"))
    assert _same_partition(got, want)


# ------------------------------------------------------------ optimize
@pytest.mark.parametrize("method", t_api.METHODS)
@pytest.mark.parametrize("hw", sorted(HWS))
@pytest.mark.parametrize("task", sorted(TASKS))
def test_optimize_numpy_matches_jax(task, hw, method):
    want = _optimize("jax", task, hw, method)
    got = _optimize("torch", task, hw, method)
    assert got.method == method and got.backend == want.backend == "numpy"
    assert _same_partition(got.partition, want.partition)
    np.testing.assert_array_equal(got.redist_mask, want.redist_mask)
    for key in ("latency", "edp", "speedup_vs_baseline"):
        _close(getattr(got, key), getattr(want, key), EXACT)
    _close(got.baseline.latency, want.baseline.latency, EXACT)
    assert got.segments() == want.segments()


def test_optimize_edp_lattice_numpy_matches_jax():
    want = _optimize("jax", "alexnet", "C2dram", "miqp", "edp")
    got = _optimize("torch", "alexnet", "C2dram", "miqp", "edp")
    assert _same_partition(got.partition, want.partition)
    _close(got.edp, want.edp, EXACT)


@pytest.mark.parametrize("hw", sorted(HWS))
@pytest.mark.parametrize("task", sorted(TASKS))
def test_lattice_on_torch_cpu_holds_the_tie_contract(task, hw):
    """The default MIQPConfig (backend "auto" → torch) on the CPU: every
    scoring chunk goes through the torch evaluator, and the result is
    JAX's numpy lattice's up to ties."""
    calls = evaluator_torch.grid_evaluate.calls["cpu"]
    scored = miqp_lattice.solve_lattice_batch.score_calls
    got = _optimize("torch", task, hw, "miqp", miqp=(), device="cpu")
    n_calls = miqp_lattice.solve_lattice_batch.score_calls - scored
    assert n_calls > 0
    assert evaluator_torch.grid_evaluate.calls["cpu"] - calls == n_calls
    want = _optimize("jax", task, hw, "miqp")
    _close(got.latency, want.latency, TORCH)
    if not _same_partition(got.partition, want.partition):
        jt, jh = _task("jax", task), _hw("jax", hw)
        ev = j_ev.Evaluator(jt, jh.replace(diagonal_links=True),
                            j_ev.EvalOptions(redistribution=True,
                                             async_exec=True))
        part = j_wl.Partition(got.partition.Px, got.partition.Py,
                              got.partition.collectors)
        _close(ev.evaluate(part, got.redist_mask).latency, want.latency,
               TORCH)


@pytest.mark.parametrize("case", [("A", "latency"), ("B", "edp")])
def test_milp_engine_matches_jax(case):
    """The HiGHS program on AlexNet over a 2x2 package: optimal in about
    a second, far inside its limit, and the same solution on both
    sides."""
    mcm, objective = case
    cfgs = [m.MIQPConfig(engine="milp", time_limit=20)
            for m in (j_miqp, t_miqp)]
    want = j_miqp.run_miqp(j_graphs.alexnet_task(),
                           j_hw.make_hw(mcm, 2, "hbm", diagonal_links=True),
                           objective, cfg=cfgs[0])
    got = t_miqp.run_miqp(t_graphs.alexnet_task(),
                          t_hw.make_hw(mcm, 2, "hbm", diagonal_links=True),
                          objective, cfg=cfgs[1])
    assert "Optimal" in got.milp_status and got.engine == "milp"
    assert got.milp_status == want.milp_status
    assert _same_partition(got.partition, want.partition)
    np.testing.assert_array_equal(got.redist_mask, want.redist_mask)
    _close(got.objective, want.objective, EXACT)
    _close(got.milp_objective, want.milp_objective, EXACT)


# ---------------------------------------------------------- pipelining
@pytest.mark.parametrize("batch", [1, 2, 4])
def test_pipeline_makespans_equal_jax(batch):
    """Every engine on AlexNet's MIQP schedule; the time-indexed MILP at 16
    buckets solves to optimality in well under its limit here."""
    segs = _optimize("torch", "alexnet", "A4hbm", "miqp").segments()
    assert segs == _optimize("jax", "alexnet", "A4hbm", "miqp").segments()
    spans = {}
    for engine in ("python", "vectorized", "milp"):
        got = t_pipe.pipeline_batch(segs, batch, config=t_pipe.PipelineConfig(
            engine=engine, n_buckets=16))
        want = j_pipe.pipeline_batch(segs, batch, config=j_pipe.PipelineConfig(
            engine=engine, n_buckets=16))
        assert got.engine == want.engine == engine
        assert (got.pipelined, got.sequential) == \
            (want.pipelined, want.sequential)
        spans[engine] = got.pipelined
    assert spans["python"] == spans["vectorized"]
    assert spans["milp"] <= spans["python"]
    jobs = t_pipe.build_jobs(segs, batch)
    ms, starts = t_pipe.vectorized_schedule(segs, batch)
    ref_ms, ref_starts = t_pipe.list_schedule(jobs)
    assert ms == ref_ms
    np.testing.assert_array_equal(
        starts.ravel(), [ref_starts[j.jid] for j in jobs])


def test_schedule_result_pipeline_matches_jax():
    got = _optimize("torch", "alexnet", "A4hbm", "miqp").pipeline(batch=8)
    want = _optimize("jax", "alexnet", "A4hbm", "miqp").pipeline(batch=8)
    assert (got.pipelined, got.sequential, got.engine) == \
        (want.pipelined, want.sequential, want.engine)
    assert got.speedup > 1.0


# -------------------------------------------------------------- sweeps
def _points(pkg):
    sweep, ev, wl = ((j_sweep, j_ev, j_wl) if pkg == "jax"
                     else (t_sweep, t_ev, t_wl))
    task, hw, hw2 = _task(pkg, "vit2"), _hw(pkg, "A4hbm"), _hw(pkg, "C2dram")
    part = wl.uniform_partition(task, hw2.X, hw2.Y)
    part.collectors[:] = 0
    opts = ev.EvalOptions(redistribution=True, async_exec=True)
    return [sweep.EvalPoint(task, hw),
            sweep.EvalPoint(task, hw.replace(diagonal_links=True), opts),
            sweep.EvalPoint(task, hw2, opts, part,
                            np.arange(len(task)) % 2 == 0)]


def _records_close(got, want, rtol):
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in ("latency", "energy", "edp", "E_sram", "E_mac", "E_mem",
                    "E_nop", "t_in", "t_comp", "t_out"):
            _close(g[key], w[key], rtol)


def test_eval_sweep_cache_and_round_trip():
    want = j_sweep.eval_sweep(_points("jax"), backend="numpy", cache=False)
    pts = _points("torch")
    t_sweep.clear_cache()
    first = t_sweep.eval_sweep(pts, backend="numpy")
    _records_close(first, want, EXACT)
    assert t_sweep.cache_stats() == {"hits": 0, "misses": 3}
    first[0]["t_in"][:] = -1.0           # records leave the cache by value
    again = t_sweep.eval_sweep(pts, backend="numpy")
    assert t_sweep.cache_stats() == {"hits": 3, "misses": 3}
    _records_close(again, want, EXACT)
    # The torch backend keys its records by device type: a CPU record
    # is never served as the card's, nor as numpy's.
    on_cpu = t_sweep.eval_sweep(pts, backend="torch", device="cpu")
    assert t_sweep.cache_stats() == {"hits": 3, "misses": 6}
    _records_close(on_cpu, want, TORCH)
    keys = {k[0] for k in t_sweep.export_cache()}
    assert keys == {"numpy", ("torch", "cpu")}
    # export → clear → import: the same records, served as hits.
    snap = t_sweep.export_cache()
    t_sweep.clear_cache()
    assert t_sweep.import_cache(snap) == 6
    assert t_sweep.import_cache(snap) == 0
    assert t_sweep.import_cache(snap, replace=True) == 6
    _records_close(t_sweep.eval_sweep(pts, backend="torch", device="cpu"),
                   on_cpu, 0.0)
    assert t_sweep.cache_stats() == {"hits": 3, "misses": 0}
    t_sweep.clear_cache()


# ------------------------------------------------- narrowings, no card
def test_ga_torch_fitness_on_cpu_matches_numpy():
    task, hw = _task("torch", "alexnet"), _hw("torch", "C2dram")
    cfg = t_ga.GAConfig(**GA)
    got = t_ga.run_ga(task, hw, cfg=dataclasses.replace(
        cfg, backend="torch", device="cpu"))
    want = t_ga.run_ga(task, hw, cfg=cfg)
    _close(got.objective, want.objective, TORCH)
    _close(got.history, want.history, TORCH)


def test_torch_without_device_raises_here(monkeypatch):
    """``backend="torch"`` (or the lattice's "auto") with ``device=None``
    means the card; without one every entry point raises, none falls
    back to numpy."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    task, hw = _task("torch", "alexnet"), _hw("torch", "A4hbm")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_api.optimize(task, hw, "miqp")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_api.optimize(task, hw, "baseline", backend="torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_api.optimize(task, hw, "ga", ga_config=t_ga.GAConfig(
            **GA, backend="torch"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_sweep.eval_sweep([t_sweep.EvalPoint(task, hw)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_sweep.solve_grid([t_sweep.EvalPoint(task, hw)], "latency",
                           t_ga.GAConfig(**GA))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_sweep.pipeline_sweep([t_sweep.PipelinePoint(
            [("a", 1.0, 2.0, 3.0)], 2)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_api.cosearch(task, hw)


def test_narrowings_name_their_roadmap_item():
    """No narrowing is left on these paths: ``method="cosearch"``
    returns ``CoSearchResult`` records, and ``devices="sharded"`` and
    ``method="multitenant"`` work."""
    from repro_torch.core.cosearch import CoSearchConfig, CoSearchResult

    task, hw = _task("torch", "alexnet"), _hw("torch", "A4hbm")
    point = [t_sweep.EvalPoint(task, hw)]
    cs_cfg = CoSearchConfig(population=8, generations=2, patience=2,
                            seed_steps=1, seed_starts=1, archive_size=4,
                            device="cpu")
    recs = t_sweep.solve_grid(
        point + [t_sweep.EvalPoint(task, dataclasses.replace(
            hw, diagonal_links=not hw.diagonal_links))], "edp", cs_cfg,
        method="cosearch", cache=False)
    assert len(recs) == 2
    for rec in recs:
        assert isinstance(rec, CoSearchResult)
        rec.partition.validate(task)
        assert rec.objective == rec.edp > 0
    assert recs[0].edp == recs[1].edp     # the diag gene searches links
    rec, = t_sweep.solve_grid(
        [t_sweep.MultiTenantPoint((task,), hw)], "edp",
        t_mt.MultiTenantConfig(method="uniform"), method="multitenant",
        backend="numpy", cache=False)
    assert isinstance(rec, t_mt.MultiTenantResult)
    small = t_sweep.EvalPoint(_task("torch", "alexnet"), hw)
    cfg = t_miqp.MIQPConfig(candidate_budget=64, eval_budget=256,
                            backend="torch", device="cpu")
    a = t_sweep.solve_grid([small], "edp", cfg, method="miqp",
                           cache=False, devices="single")[0]
    b = t_sweep.solve_grid([small], "edp", cfg, method="miqp",
                           cache=False, devices="sharded")[0]
    assert a.objective == b.objective
    np.testing.assert_array_equal(a.partition.Px, b.partition.Px)
    res = _optimize("torch", "alexnet", "A4hbm", "baseline")
    # Flow congestion (A.3) is no narrowing any more: it re-scores.
    flow = res.segments(congestion="flow")
    assert [s[0] for s in flow] == [s[0] for s in res.segments()]
    assert flow != res.segments()
    assert res.segments("regime") == res.segments()
