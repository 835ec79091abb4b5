"""The GA's batched engines in the port (``repro_torch.core.ga``'s
vectorized numpy engine and ``repro_torch.core.ga_torch``, the device
engine) against the JAX package's (DESIGN.md §10). The JAX package runs
on its numpy engines: its device engine needs
``jax.experimental.enable_x64``, which jax 0.9 lacks (ROADMAP.md).

Contracts: the port's vectorized numpy engine equals JAX's bit for bit
at fixed seeds (partition, history, evaluations), and so do its
operators from the same ``default_rng``. The torch engine (here on the
CPU) draws from a torch generator, so it is held to the JAX suite's
properties (``tests/test_core_ga_engines.py``: exact sums, the domain
window, a best objective that never regresses, elitism), to determinism
at a fixed seed, to solo == island-batched bit for bit, and to solution
quality: the median over 5 seeds within 1% of JAX's python engine."""
import dataclasses

import numpy as np
import pytest

from repro import graphs as j_graphs
from repro.core import evaluator as j_ev
from repro.core import ga as j_ga
from repro.core import hw as j_hw
from repro.core import workload as j_wl
from repro_torch import graphs as t_graphs
from repro_torch.core import api as t_api
from repro_torch.core import evaluator as t_ev
from repro_torch.core import evaluator_torch
from repro_torch.core import ga as t_ga
from repro_torch.core import ga_torch
from repro_torch.core import hw as t_hw
from repro_torch.core import workload as t_wl

PKGS = {"jax": (j_ev, j_ga, j_hw, j_wl), "torch": (t_ev, t_ga, t_hw, t_wl)}


def divisible_task(pkg, n_ops=4, mx=4, nx=4, X=4, Y=4, R=16, C=16):
    """The JAX suite's task: dims exact multiples of (X*R)/(Y*C), so the
    uniform partition sits on the window center."""
    wl = PKGS[pkg][3]
    ops = [wl.GemmOp("g0", M=mx * X * R, K=256, N=nx * Y * C)]
    for i in range(1, n_ops):
        ops.append(wl.GemmOp(f"g{i}", M=mx * X * R, K=ops[-1].N,
                             N=nx * Y * C, chained=True, sync=(i % 3 == 0)))
    return wl.Task(f"div{n_ops}_{mx}_{nx}", ops)


def opts(pkg):
    return PKGS[pkg][0].EvalOptions(redistribution=True, async_exec=True)


def hw_a4(pkg, **kw):
    return PKGS[pkg][2].make_hw("A", 4, "hbm", **kw)


def torch_cfg(**kw):
    return t_ga.GAConfig(engine="vectorized", backend="torch", device="cpu",
                         **kw)


def assert_invariants(task, hw, cfg, result):
    """``tests/test_core_ga_engines.py``'s invariants."""
    part = result.partition
    part.validate(task)                       # exact per-op sums
    lo, hi = t_wl.partition_domain(task, hw.X, hw.Y, hw.R, hw.C, cfg.slack)
    for i in range(len(task)):
        assert (part.Px[i] % hw.R == 0).all()
        assert (part.Px[i] >= lo[i, 0] * hw.R).all()
        assert (part.Px[i] <= hi[i, 0] * hw.R).all()
        assert (part.Py[i] % hw.C == 0).all()
        assert (part.Py[i] >= lo[i, 1] * hw.C).all()
        assert (part.Py[i] <= hi[i, 1] * hw.C).all()
    assert (part.collectors >= 0).all() and (part.collectors < hw.Y).all()
    assert (np.diff(result.history) <= 1e-18).all()
    assert result.objective == pytest.approx(result.history[-1])
    assert result.evaluations == len(result.history) * cfg.population


def assert_same(a, b):
    assert a.objective == b.objective
    np.testing.assert_array_equal(a.partition.Px, b.partition.Px)
    np.testing.assert_array_equal(a.partition.Py, b.partition.Py)
    np.testing.assert_array_equal(a.partition.collectors,
                                  b.partition.collectors)
    np.testing.assert_array_equal(a.redist_mask, b.redist_mask)
    np.testing.assert_array_equal(a.history, b.history)
    assert a.evaluations == b.evaluations


# ------------------------------------------- the vectorized numpy engine
VEC_CASES = {
    "alexnet": dict(),
    "freeze_redist": dict(freeze_redist=True),
    "oversized_elite": dict(elite=40, population=12),
    "edp": dict(),
}


@pytest.mark.parametrize("case", VEC_CASES)
@pytest.mark.parametrize("seed", [0, 5])
def test_vectorized_numpy_engine_equals_jax(case, seed):
    """Same numpy RNG, same operators, same evaluator: bit for bit."""
    kw = dict(generations=12, population=16, patience=6, seed=seed)
    kw.update(VEC_CASES[case])
    objective = "edp" if case == "edp" else "latency"
    got, want = [
        PKGS[pkg][1].run_ga(
            (t_graphs if pkg == "torch" else j_graphs).WORKLOADS["alexnet"](),
            hw_a4(pkg, diagonal_links=True), objective, opts(pkg),
            PKGS[pkg][1].GAConfig(**kw), backend="numpy",
            engine="vectorized")
        for pkg in ("torch", "jax")]
    assert_same(got, want)


def test_move_units_and_tournament_equal_jax():
    """The batched operators consume the same draws from the same
    ``default_rng`` and leave the same arrays and the same RNG state."""
    for seed in range(4):
        states = []
        for mod in (t_ga, j_ga):
            rng = np.random.default_rng(seed)
            P_ = np.full((8, 3, 4), 4 * 16, dtype=np.int64)
            lo = np.array([2, 3, 1])
            hi = np.array([6, 5, 7])
            for _ in range(5):
                mod._move_units_vec(rng, P_, 16, lo, hi,
                                    rng.random((8, 3)) < 0.7)
            fit = rng.random(17)
            win = mod._tournament_vec(rng, fit, 3, 32)
            states.append((P_, win, rng.random(4)))
        for a, b in zip(*states):
            np.testing.assert_array_equal(a, b)


def test_population_init_equals_jax():
    for seed in (0, 9):
        cfgs = [torch_cfg(seed=seed, population=12),
                j_ga.GAConfig(seed=seed, population=12)]
        t, j = [mod._random_population_vec(
            np.random.default_rng(seed), divisible_task(pkg), hw_a4(pkg),
            cfg, 12)
            for mod, pkg, cfg in ((t_ga, "torch", cfgs[0]),
                                  (j_ga, "jax", cfgs[1]))]
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)


def test_unknown_engine_rejected():
    with pytest.raises(ValueError, match="engine"):
        t_ga.run_ga(divisible_task("torch", n_ops=2), t_hw.make_hw("A", 2),
                    engine="fortran")
    assert t_ga.ENGINES == j_ga.ENGINES


# --------------------------------------------- the torch engine (on CPU)
@pytest.mark.parametrize("seed", [0, 3])
def test_torch_engine_invariants(seed):
    task = divisible_task("torch")
    hw = hw_a4("torch", diagonal_links=True)
    cfg = torch_cfg(generations=10, population=24, patience=10, seed=seed)
    r = t_ga.run_ga(task, hw, "latency", opts("torch"), cfg)
    assert_invariants(task, hw, cfg, r)


def test_torch_engine_elitism_beats_uniform():
    task = divisible_task("torch")
    hw = hw_a4("torch", diagonal_links=True)
    cfg = torch_cfg(generations=10, population=24, patience=10, seed=1)
    base = t_ev.Evaluator(task, hw, opts("torch")).evaluate(
        t_wl.uniform_partition(task, hw.X, hw.Y))
    r = t_ga.run_ga(task, hw, "latency", opts("torch"), cfg)
    assert r.objective <= base.latency * (1 + 1e-12)


def test_torch_engine_deterministic_given_seed():
    task = divisible_task("torch", n_ops=3)
    hw = t_hw.make_hw("A", 4)
    cfg = torch_cfg(generations=6, population=24, patience=6, seed=9)
    a = t_ga.run_ga(task, hw, "latency", opts("torch"), cfg)
    b = t_ga.run_ga(task, hw, "latency", opts("torch"), cfg)
    assert_same(a, b)


def test_torch_engine_zero_patience_runs_one_generation():
    task = divisible_task("torch", n_ops=2)
    hw = t_hw.make_hw("A", 4)
    cfg = torch_cfg(generations=5, population=8, patience=0, seed=0)
    r = t_ga.run_ga(task, hw, "latency", opts("torch"), cfg)
    assert len(r.history) == 1
    assert r.evaluations == cfg.population
    assert_invariants(task, hw, cfg, r)


def test_torch_engine_oversized_elite_clamped():
    task = divisible_task("torch", n_ops=2)
    hw = t_hw.make_hw("A", 4)
    cfg = torch_cfg(generations=3, population=4, elite=8, patience=3)
    r = t_ga.run_ga(task, hw, "latency", opts("torch"), cfg)
    assert r.objective > 0
    assert r.evaluations == len(r.history) * cfg.population


def test_torch_engine_early_stop_matches_flat_history():
    """An island that stops early reports exactly the generations it
    evaluated: its history ends at the first generation whose flat
    count reached patience, before the generation budget."""
    task = divisible_task("torch", n_ops=2)
    hw = t_hw.make_hw("A", 4)
    cfg = torch_cfg(generations=200, population=8, patience=3, seed=0)
    r = t_ga.run_ga(task, hw, "latency", opts("torch"), cfg)
    assert 4 <= len(r.history) < 200
    assert_invariants(task, hw, cfg, r)


def test_torch_engine_seeds_warm_start():
    """``seeds``: rows 1.. of generation 0 are the given partitions (row
    0 stays uniform, the other genes keep the cold init), and a solve of
    one generation finds the best seed."""
    task = divisible_task("torch")
    hw = hw_a4("torch", diagonal_links=True)
    cfg = torch_cfg(generations=20, population=16, patience=20, seed=2)
    found = t_ga.run_ga(task, hw, "latency", opts("torch"), cfg)
    props = [found.partition, t_wl.uniform_partition(task, hw.X, hw.Y)]
    cold = ga_torch._initial_population([task], [hw], cfg, 16, None)[0]
    warm = ga_torch._initial_population([task], [hw], cfg, 16, [props])[0]
    for j, p in enumerate(props):
        np.testing.assert_array_equal(warm[0][j + 1], p.Px)
        np.testing.assert_array_equal(warm[1][j + 1], p.Py)
    np.testing.assert_array_equal(warm[0][0], cold[0][0])
    np.testing.assert_array_equal(warm[0][3:], cold[0][3:])
    for a, b in zip(warm[2:], cold[2:]):
        np.testing.assert_array_equal(a, b)
    one = dataclasses.replace(cfg, generations=1)
    r = ga_torch.solve_islands([task], [hw], opts("torch"), "latency", one,
                               seeds=[props])[0]
    ev = t_ev.Evaluator(task, hw, opts("torch"))
    seeded = ev.evaluate(found.partition, found.redist_mask).latency
    assert r.history.shape == (1,)
    assert r.objective <= seeded * (1 + 1e-12)
    with pytest.raises(ValueError, match="align"):
        ga_torch.solve_islands([task], [hw], opts("torch"), "latency", one,
                               seeds=[props, props])


def test_torch_engine_solo_equals_island_batch():
    """A point solved inside an island batch equals the same point solved
    alone, bit for bit: the draws are shared by every island and the
    fitness reduces along each point's own axes."""
    task = divisible_task("torch")
    hws = [hw_a4("torch", diagonal_links=True, bw_nop=b)
           for b in (48.0, 64.0, 96.0)]
    cfg = torch_cfg(generations=12, population=24, patience=5, seed=2)
    batch = ga_torch.solve_islands([task] * 3, hws, opts("torch"), "edp",
                                   cfg)
    for hw, rec in zip(hws, batch):
        assert_same(rec, t_ga.run_ga(task, hw, "edp", opts("torch"), cfg))
        assert_invariants(task, hw, cfg, rec)


def test_torch_engine_counts_fitness_calls_on_its_device():
    task = divisible_task("torch", n_ops=2)
    cfg = torch_cfg(generations=5, population=8, patience=5, seed=0)
    calls = evaluator_torch.grid_evaluate.calls
    before = calls["cpu"]
    r = t_ga.run_ga(task, t_hw.make_hw("A", 4), "latency", opts("torch"),
                    cfg)
    assert calls["cpu"] - before == len(r.history)


def test_torch_engine_rejects_sharded_and_bad_objective():
    """``devices="sharded"`` runs (on a one-entry mesh here) and equals
    the single-device search bit for bit; a bad devices mode or
    objective is rejected."""
    task = divisible_task("torch", n_ops=2)
    hw = t_hw.make_hw("A", 4)
    cfg = torch_cfg(generations=4, population=8, patience=4, seed=0)
    assert_same(t_ga.run_ga(task, hw, "latency", opts("torch"),
                            dataclasses.replace(cfg, devices="sharded")),
                t_ga.run_ga(task, hw, "latency", opts("torch"), cfg))
    with pytest.raises(ValueError, match="devices"):
        t_ga.run_ga(task, hw, "latency", opts("torch"),
                    torch_cfg(devices="tpu"))
    with pytest.raises(ValueError, match="objective"):
        ga_torch.solve_islands([task], [hw], opts("torch"), "speed",
                               torch_cfg())


def test_front_door_passes_the_device_engine_through():
    """``optimize(method="ga")`` runs the GAConfig it is given: the device
    engine's result, scored by the same backend."""
    task = t_graphs.WORKLOADS["alexnet"]()
    hw = t_hw.make_hw("A", 4, "hbm")
    cfg = torch_cfg(generations=8, population=16, patience=8, seed=4)
    r = t_api.optimize(task, hw, "ga", ga_config=cfg)
    want = ga_torch.run_ga_torch(task, hw.replace(diagonal_links=True),
                                 "latency", opts("torch"), cfg)
    np.testing.assert_array_equal(r.partition.Px, want.partition.Px)
    assert r.backend == "torch"
    assert r.latency == pytest.approx(want.objective, rel=1e-9)


def _median(run, seeds):
    return float(np.median([run(s).objective for s in seeds]))


@pytest.mark.parametrize("wname", ["alexnet", "vit"])
def test_torch_engine_quality_within_one_percent_of_python(wname):
    """The JAX suite's quality test at its sizes: the median over 5 seeds
    of the torch engine (CPU) within 1% of JAX's python engine."""
    kw = dict(generations=30, population=32, patience=30)
    seeds = range(5)
    j_task = j_graphs.WORKLOADS[wname](batch=1)
    t_task = t_graphs.WORKLOADS[wname](batch=1)
    py = _median(lambda s: j_ga.run_ga(
        j_task, hw_a4("jax", diagonal_links=True), "latency", opts("jax"),
        j_ga.GAConfig(seed=s, **kw), backend="numpy", engine="python"),
        seeds)
    vec = _median(lambda s: t_ga.run_ga(
        t_task, hw_a4("torch", diagonal_links=True), "latency",
        opts("torch"), torch_cfg(seed=s, **kw)), seeds)
    assert vec == pytest.approx(py, rel=0.01)
