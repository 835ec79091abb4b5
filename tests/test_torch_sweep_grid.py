"""The port's sweep engine past ``eval_sweep`` (``repro_torch.core.sweep``:
``grid``, ``run_grid``, ``solve_grid``, ``SweepCheckpointer``) against
the JAX package's, on tasks and MCMs built in each package from the same
numbers. The JAX package runs on its numpy engines (its JAX backends need
``jax.experimental.enable_x64``, which jax 0.9 lacks: ROADMAP.md).

Contracts: numpy-backend records equal JAX's bit for bit (GA: the
vectorized numpy engine; MIQP: the lattice); the lattice scored by the
torch evaluator on the CPU is held to the tie contract (objective at rtol
1e-9, partition equal or else re-scored by the JAX numpy evaluator
within 1e-9); the torch GA's island records equal its solo solves bit
for bit; records are cached per backend and per torch device type;
checkpointed sweeps resume with exact hit accounting (the JAX suite's
``tests/test_sweep_checkpoint.py`` cases through the port's store)."""
import numpy as np
import pytest

from repro import graphs as j_graphs
from repro.core import evaluator as j_ev
from repro.core import ga as j_ga
from repro.core import hw as j_hw
from repro.core import miqp as j_miqp
from repro.core import sweep as j_sweep
from repro.core import workload as j_wl
from repro_torch import graphs as t_graphs
from repro_torch.core import evaluator as t_ev
from repro_torch.core import ga as t_ga
from repro_torch.core import hw as t_hw
from repro_torch.core import miqp as t_miqp
from repro_torch.core import sweep as t_sweep
from repro_torch.core import workload as t_wl

PKGS = {"jax": (j_ev, j_ga, j_hw, j_miqp, j_sweep, j_wl, j_graphs),
        "torch": (t_ev, t_ga, t_hw, t_miqp, t_sweep, t_wl, t_graphs)}
TIE_RTOL = 1e-9
GA = dict(generations=8, population=16, patience=4, seed=2)


@pytest.fixture(autouse=True)
def _fresh_cache():
    t_sweep.clear_cache()
    j_sweep.clear_cache()
    yield
    t_sweep.clear_cache()
    j_sweep.clear_cache()


def toy_task(pkg, n=3, m=512):
    """The JAX checkpoint suite's task."""
    wl = PKGS[pkg][5]
    ops = [wl.GemmOp("g0", M=m, K=256, N=512)]
    for i in range(1, n):
        ops.append(wl.GemmOp(f"g{i}", M=m, K=ops[-1].N, N=512,
                             chained=True))
    return wl.Task(f"toy{n}_{m}", ops)


def toy_points(pkg, k=6):
    ev, _, hw, _, sweep, _, _ = PKGS[pkg]
    task = toy_task(pkg)
    return [sweep.EvalPoint(task, hw.make_hw("A", 4, "hbm", bw_nop=64.0 + i),
                            ev.EvalOptions(redistribution=True))
            for i in range(k)]


def solver_points(pkg):
    """AlexNet and a narrower AlexNet on 4x4 type-A HBM at two NoP rates
    (two shape groups of two points) with GA options."""
    ev, _, hw, _, sweep, _, graphs = PKGS[pkg]
    opts = ev.EvalOptions(redistribution=True, async_exec=True)
    tasks = [graphs.WORKLOADS["alexnet"](), toy_task(pkg, n=4)]
    return [sweep.EvalPoint(t, hw.make_hw("A", 4, "hbm", diagonal_links=True,
                                          bw_nop=b), opts)
            for t in tasks for b in (48.0, 64.0)]


def assert_same_ga(a, b):
    assert a.objective == b.objective
    for f in ("Px", "Py", "collectors"):
        np.testing.assert_array_equal(getattr(a.partition, f),
                                      getattr(b.partition, f))
    np.testing.assert_array_equal(a.redist_mask, b.redist_mask)
    np.testing.assert_array_equal(a.history, b.history)
    assert a.evaluations == b.evaluations


# ------------------------------------------------------------ grid, run_grid
def test_grid_order_equals_jax():
    axes = dict(a=[1, 2], b="xyz", c=(0.5, None))
    assert t_sweep.grid(**axes) == j_sweep.grid(**axes)
    assert t_sweep.grid(a=[1, 2], b="xy")[:2] == [{"a": 1, "b": "x"},
                                                  {"a": 1, "b": "y"}]
    assert t_sweep.grid() == [{}]


def test_run_grid_times_and_emits():
    seen = []
    out = t_sweep.run_grid(t_sweep.grid(x=[1, 2, 3]), lambda x: x * x,
                           emit=lambda pt, res, us: seen.append((pt, res)))
    assert [r for _, r, _ in out] == [1, 4, 9]
    assert all(us >= 0 for _, _, us in out)
    assert seen == [({"x": 1}, 1), ({"x": 2}, 4), ({"x": 3}, 9)]


def test_run_grid_progress_and_checkpoint(tmp_path, capsys):
    path = str(tmp_path / "store.bin")
    pts = toy_points("torch", 3)
    out = t_sweep.run_grid(
        [{"i": i} for i in range(3)],
        lambda i: t_sweep.eval_sweep([pts[i]], backend="numpy")[0],
        progress="grid", checkpoint=path)
    assert len(out) == 3
    err = capsys.readouterr().err
    assert "grid point 3/3" in err
    assert "pts/s" in err and "eta" in err
    t_sweep.clear_cache()
    t_sweep.eval_sweep(pts, backend="numpy", checkpoint=path)
    assert t_sweep.cache_stats() == {"hits": 3, "misses": 0}


# --------------------------------------------------- solve_grid, method ga
def test_solve_grid_ga_numpy_equals_jax():
    cfgs = {pkg: PKGS[pkg][1].GAConfig(**GA) for pkg in PKGS}
    got, want = [PKGS[pkg][4].solve_grid(solver_points(pkg), "latency",
                                         cfgs[pkg], backend="numpy",
                                         cache=False)
                 for pkg in ("torch", "jax")]
    for a, b in zip(got, want):
        assert_same_ga(a, b)


def test_solve_grid_ga_torch_islands_equal_solo_solves():
    pts = solver_points("torch")
    cfg = t_ga.GAConfig(**GA)
    recs = t_sweep.solve_grid(pts, "edp", cfg, device="cpu", cache=False)
    for pt, rec in zip(pts, recs):
        solo = t_ga.run_ga(pt.task, pt.hw, "edp", pt.options,
                           t_ga.GAConfig(device="cpu", **GA),
                           backend="torch", engine="vectorized")
        assert_same_ga(rec, solo)
        solo_grid = t_sweep.solve_grid([pt], "edp", cfg, device="cpu",
                                       cache=False)[0]
        assert_same_ga(rec, solo_grid)


def test_solve_grid_ga_caches_per_backend_and_device():
    pts = solver_points("torch")[:1]
    cfg = t_ga.GAConfig(**GA)
    a = t_sweep.solve_grid(pts, "latency", cfg, backend="numpy")[0]
    assert t_sweep.cache_stats() == {"hits": 0, "misses": 1}
    b = t_sweep.solve_grid(pts, "latency", cfg, backend="numpy")[0]
    assert t_sweep.cache_stats() == {"hits": 1, "misses": 1}
    assert_same_ga(a, b)
    # "auto" at P 16 resolves to numpy first: the same record
    t_sweep.solve_grid(pts, "latency", cfg, backend="auto")
    assert t_sweep.cache_stats() == {"hits": 2, "misses": 1}
    # the torch engine is its own record, keyed by its device type; the
    # device knobs of the config are not part of the key
    c = t_sweep.solve_grid(pts, "latency", cfg, device="cpu")[0]
    assert t_sweep.cache_stats()["misses"] == 2
    t_sweep.solve_grid(pts, "latency",
                       t_ga.GAConfig(device="cpu", devices="single", **GA))
    assert t_sweep.cache_stats() == {"hits": 3, "misses": 2}
    keys = list(t_sweep.export_cache())
    assert {k[1] for k in keys} == {"numpy", ("torch", "cpu")}
    # another objective / config is another record
    t_sweep.solve_grid(pts, "edp", cfg, backend="numpy")
    t_sweep.solve_grid(pts, "latency", t_ga.GAConfig(**{**GA, "seed": 7}),
                       backend="numpy")
    assert t_sweep.cache_stats()["misses"] == 4
    # records cross the cache boundary by value
    c.partition.Px[0, 0] += 1
    c.history[0] = -1.0
    d = t_sweep.solve_grid(pts, "latency", cfg, device="cpu")[0]
    assert d.history[0] != -1.0
    assert not np.array_equal(c.partition.Px, d.partition.Px)


def test_solve_grid_validation_and_narrowings(monkeypatch):
    pts = solver_points("torch")[:1]
    cfg = t_ga.GAConfig(**GA)
    with pytest.raises(ValueError, match="backend"):
        t_sweep.solve_grid(pts, "latency", cfg, backend="jax")
    with pytest.raises(ValueError, match="backend"):
        t_sweep.solve_grid(pts, "latency", t_miqp.MIQPConfig(),
                           backend="np", method="miqp")
    with pytest.raises(ValueError, match="method"):
        t_sweep.solve_grid(pts, "latency", cfg, method="anneal")
    with pytest.raises(ValueError, match="backend"):
        t_sweep.eval_sweep(pts, backend="auto")
    # method="cosearch" dispatches to cosearch_sweep with every knob.
    seen = []
    monkeypatch.setattr(t_sweep, "cosearch_sweep",
                        lambda *a, **kw: seen.append((a, kw)) or ["rec"])
    assert t_sweep.solve_grid(pts, "edp", "cfg", method="cosearch",
                              cache=False, devices="single",
                              device="cpu") == ["rec"]
    (args, kw), = seen
    assert args == (pts,)
    assert kw == dict(objective="edp", cfg="cfg", backend="torch",
                      cache=False, devices="single", checkpoint=None,
                      checkpoint_every=8, straggler=None, device="cpu")
    monkeypatch.undo()
    with pytest.raises(TypeError, match="MultiTenantConfig"):
        t_sweep.solve_grid(pts, "edp", cfg, method="multitenant")
    with pytest.raises(ValueError, match="devices"):
        t_sweep.solve_grid(pts, "latency", cfg, device="cpu",
                           devices="tpu")
    with pytest.raises(ValueError, match="devices"):
        t_sweep.solve_grid(pts, "latency", t_miqp.MIQPConfig(),
                           method="miqp", device="cpu", devices="tpu")
    with pytest.raises(ValueError, match="devices"):
        t_sweep.eval_sweep(pts, device="cpu", devices="tpu")


# ------------------------------------------------- solve_grid, method miqp
def _miqp_points(pkg):
    ev, _, hw, _, sweep, _, graphs = PKGS[pkg]
    opts = ev.EvalOptions(redistribution=True, async_exec=False)
    return [sweep.EvalPoint(graphs.WORKLOADS["alexnet"](),
                            hw.make_hw(t, 4, "hbm", diagonal_links=True),
                            opts)
            for t in "AB"]


def test_solve_grid_miqp_numpy_equals_jax_and_torch_ties():
    want = j_sweep.solve_grid(_miqp_points("jax"), "latency",
                              j_miqp.MIQPConfig(), backend="numpy",
                              cache=False, method="miqp")
    got = t_sweep.solve_grid(_miqp_points("torch"), "latency",
                             t_miqp.MIQPConfig(), backend="numpy",
                             method="miqp")
    for a, b in zip(got, want):
        assert a.objective == b.objective
        np.testing.assert_array_equal(a.partition.Px, b.partition.Px)
        np.testing.assert_array_equal(a.partition.Py, b.partition.Py)
        assert a.milp_status == b.milp_status and a.engine == b.engine
    on_cpu = t_sweep.solve_grid(_miqp_points("torch"), "latency",
                                t_miqp.MIQPConfig(), device="cpu",
                                method="miqp")
    assert t_sweep.cache_stats() == {"hits": 0, "misses": 4}
    for pt, a, b in zip(_miqp_points("jax"), on_cpu, want):
        assert abs(a.objective - b.objective) <= TIE_RTOL * b.objective
        if not np.array_equal(a.partition.Px, b.partition.Px):
            ev = j_ev.Evaluator(pt.task, pt.hw, pt.options)
            part = j_wl.Partition(a.partition.Px, a.partition.Py,
                                  a.partition.collectors)
            rescored = ev.evaluate(part, a.redist_mask).latency
            assert abs(rescored - b.objective) <= TIE_RTOL * b.objective
    # a solo lattice solve is the G = 1 case of the same program
    solo = t_miqp.run_miqp(_miqp_points("torch")[1].task,
                           _miqp_points("torch")[1].hw, "latency",
                           _miqp_points("torch")[1].options,
                           t_miqp.MIQPConfig(backend="torch", device="cpu"))
    assert solo.objective == on_cpu[1].objective
    np.testing.assert_array_equal(solo.partition.Px, on_cpu[1].partition.Px)


# ------------------------------------------------------ checkpointed resume
def test_checkpoint_requires_cache(tmp_path):
    with pytest.raises(ValueError, match="cache=True"):
        t_sweep.eval_sweep(toy_points("torch", 2), backend="numpy",
                           cache=False, checkpoint=str(tmp_path / "s.bin"))


def test_eval_sweep_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "store.bin")
    pts = toy_points("torch")
    recs = t_sweep.eval_sweep(pts, backend="numpy", checkpoint=path,
                              checkpoint_every=2)
    assert t_sweep.cache_stats() == {"hits": 0, "misses": 6}
    want = j_sweep.eval_sweep(toy_points("jax"), backend="numpy",
                              cache=False)
    for a, b in zip(recs, want):
        assert a["latency"] == b["latency"] and a["edp"] == b["edp"]
    t_sweep.clear_cache()
    recs2 = t_sweep.eval_sweep(pts, backend="numpy", checkpoint=path,
                               checkpoint_every=2)
    assert t_sweep.cache_stats() == {"hits": 6, "misses": 0}
    for a, b in zip(recs, recs2):
        assert a["latency"] == b["latency"]
        assert np.array_equal(a["t_in"], b["t_in"])


def test_partial_store_resumes_tail_only(tmp_path):
    path = str(tmp_path / "store.bin")
    pts = toy_points("torch")
    t_sweep.eval_sweep(pts[:4], backend="numpy", checkpoint=path)
    t_sweep.clear_cache()
    ckpt = t_sweep.SweepCheckpointer(path)
    assert ckpt.resumed == 4 and ckpt.pending() == 0
    t_sweep.eval_sweep(pts, backend="numpy", checkpoint=ckpt)
    assert t_sweep.cache_stats() == {"hits": 4, "misses": 2}
    assert ckpt.pending() == 0


class _Recorder:
    """A duck-typed straggler monitor: records what it observes."""

    def __init__(self, flag=False):
        self.seen, self.flag = [], flag

    def observe(self, chunk, seconds):
        self.seen.append((chunk, seconds))
        return self.flag


def test_solve_grid_checkpoint_and_straggler(tmp_path):
    path = str(tmp_path / "store.bin")
    pts = toy_points("torch", 4)
    cfg = t_ga.GAConfig(population=16, generations=2, seed=1)
    mon = _Recorder()
    recs = t_sweep.solve_grid(pts, "latency", cfg, backend="numpy",
                              checkpoint=path, checkpoint_every=2,
                              straggler=mon)
    assert [c for c, _ in mon.seen] == [0, 1]
    assert all(s > 0 for _, s in mon.seen)
    t_sweep.clear_cache()
    again = t_sweep.solve_grid(pts, "latency", cfg, backend="numpy",
                               checkpoint=path, checkpoint_every=2)
    assert t_sweep.cache_stats() == {"hits": 4, "misses": 0}
    for a, b in zip(recs, again):
        assert_same_ga(a, b)


def test_straggler_flag_emits_stderr_line(tmp_path, capsys):
    t_sweep.eval_sweep(toy_points("torch", 4), backend="numpy",
                       checkpoint=str(tmp_path / "s.bin"),
                       checkpoint_every=2, straggler=_Recorder(flag=True))
    assert "straggler" in capsys.readouterr().err


def test_torch_records_persist_by_device(tmp_path):
    """Torch records (keyed by device type) round-trip the store like the
    numpy ones: the store brings back the same GA record."""
    path = str(tmp_path / "store.bin")
    pts = solver_points("torch")[:1]
    cfg = t_ga.GAConfig(**GA)
    a = t_sweep.solve_grid(pts, "latency", cfg, device="cpu",
                           checkpoint=path)[0]
    t_sweep.clear_cache()
    b = t_sweep.solve_grid(pts, "latency", cfg, device="cpu",
                           checkpoint=path)[0]
    assert t_sweep.cache_stats() == {"hits": 1, "misses": 0}
    assert_same_ga(a, b)
