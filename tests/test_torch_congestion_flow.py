"""The evaluator's ``congestion="flow"`` mode in the port
(``core/evaluator.py`` on numpy, ``core/evaluator_torch.py`` on the CPU,
where the waterfilling kernel's plain version runs), against the JAX
package's numpy ``Evaluator``: the cases of ``tests/test_congestion_flow.py``
through both packages, from the same numbers.

Contracts: the port's numpy evaluator equals JAX's at rtol 1e-12, the
torch backend at rtol 1e-9 (DESIGN.md §8); sweeps cache per congestion
mode and regime records keep their keys; GA solves under flow on the
python and vectorized numpy engines equal JAX's bit for bit, and the
device engine's records score equal under JAX's numpy evaluator;
``segments("flow")`` equals JAX's at rtol 1e-12. Meshes are 4x4 and
smaller."""
import dataclasses

import numpy as np
import pytest

from repro.core import api as j_api
from repro.core import evaluator as j_ev
from repro.core import ga as j_ga
from repro.core import hw as j_hw
from repro.core import miqp as j_miqp
from repro.core import sweep as j_sweep
from repro.core import workload as j_wl
from repro_torch.core import api as t_api
from repro_torch.core import evaluator as t_ev
from repro_torch.core import ga as t_ga
from repro_torch.core import hw as t_hw
from repro_torch.core import miqp as t_miqp
from repro_torch.core import sweep as t_sweep
from repro_torch.core import workload as t_wl
from repro_torch.kernels.netsim import kernel as nk

PKGS = {"jax": (j_ev, j_hw, j_sweep, j_wl), "torch": (t_ev, t_hw, t_sweep,
                                                      t_wl)}
EXACT = 1e-12
TORCH = 1e-9
KEYS = ("latency", "energy", "edp", "t_in", "t_comp", "t_out", "E_sram",
        "E_mac", "E_mem", "E_nop")


@pytest.fixture(autouse=True)
def _fresh_cache():
    t_sweep.clear_cache()
    j_sweep.clear_cache()
    yield
    t_sweep.clear_cache()
    j_sweep.clear_cache()


def toy_task(pkg, n=3):
    """``tests/test_congestion_flow.py``'s task."""
    wl = PKGS[pkg][3]
    ops = [wl.GemmOp("g0", M=512, K=256, N=512)]
    for i in range(1, n):
        ops.append(wl.GemmOp(f"g{i}", M=512, K=ops[-1].N, N=512,
                             chained=True, sync=(i == 1)))
    return wl.Task(f"flowtoy{n}", ops)


def _pair(t, g=4, memory="hbm", diagonal=False, n=3):
    return tuple((toy_task(p, n),
                  PKGS[p][1].make_hw(t, g, memory, diagonal_links=diagonal))
                 for p in ("jax", "torch"))


def _close(got, want, rtol):
    for k in KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=0,
                                   err_msg=k)


def test_bad_congestion_rejected():
    (_, _), (tt, th) = _pair("A")
    with pytest.raises(ValueError, match="congestion"):
        t_ev.EvalOptions(congestion="astral")
    with pytest.raises(ValueError, match="congestion"):
        t_ev.Evaluator(tt, th, congestion="astral")
    assert t_ev.CONGESTION_MODES == j_ev.CONGESTION_MODES


def test_ctor_override_merges_into_options():
    (_, _), (tt, th) = _pair("A")
    ev = t_ev.Evaluator(tt, th, t_ev.EvalOptions(redistribution=True),
                        congestion="flow")
    assert ev.opts.congestion == "flow"
    assert ev.opts.redistribution is True
    assert ev.consts()["flow_routes"].shape == (2, 16, 7)
    regime = t_ev.Evaluator(tt, th).consts()
    for k in ("flow_cap", "dist_inc", "coll_inc", "flow_routes"):
        assert regime[k].shape == (1,) and not regime[k].any()


@pytest.mark.parametrize("t", list("ABCD"))
def test_flow_mode_types_match_jax(t):
    """Both port backends against JAX's numpy reference, every
    packaging type (the JAX suite's backend-parity case)."""
    (jt, jh), (tt, th) = _pair(t, diagonal=(t == "A"))
    opts = dict(redistribution=True, async_exec=True, congestion="flow")
    want = j_ev.Evaluator(jt, jh, j_ev.EvalOptions(**opts)).evaluate(
        j_wl.uniform_partition(jt, 4, 4))
    part = t_wl.uniform_partition(tt, 4, 4)
    for backend, rtol in (("numpy", EXACT), ("torch", TORCH)):
        got = t_ev.Evaluator(tt, th, t_ev.EvalOptions(**opts),
                             backend=backend, device="cpu").evaluate(part)
        assert got.latency == pytest.approx(want.latency, rel=rtol)
        assert got.energy == pytest.approx(want.energy, rel=rtol)
        np.testing.assert_allclose(got.t_in, want.t_in, rtol=rtol)
        np.testing.assert_allclose(got.t_out, want.t_out, rtol=rtol)


@pytest.mark.parametrize("opts", [dict(), dict(redistribution=True,
                                               async_exec=True)],
                         ids=["ls", "redist-async"])
def test_flow_mode_batch_parity(opts):
    """A population of perturbed partitions and random collectors: every
    result key of both backends against JAX's numpy batch."""
    (jt, jh), (tt, th) = _pair("A", n=2)
    opts = dict(opts, congestion="flow")
    rng = np.random.default_rng(0)
    base = j_wl.uniform_partition(jt, 4, 4)
    P = 4
    Px = np.repeat(base.Px[None], P, 0).astype(float)
    Py = np.repeat(base.Py[None], P, 0).astype(float)
    Px[1:, :, 0] += 16.0
    Px[1:, :, 3] -= 16.0
    Py[2:, :, 1] += 32.0
    Py[2:, :, 2] -= 32.0
    co = rng.integers(0, 4, (P, 2))
    rd = rng.integers(0, 2, (P, 2)).astype(float)
    want = j_ev.Evaluator(jt, jh, j_ev.EvalOptions(**opts)).evaluate_batch(
        Px, Py, co, rd)
    for backend, rtol in (("numpy", EXACT), ("torch", TORCH)):
        got = t_ev.Evaluator(tt, th, t_ev.EvalOptions(**opts),
                             backend=backend, device="cpu").evaluate_batch(
            Px, Py, co, rd)
        _close(got, want, rtol)


def test_flow_differs_from_regime_and_energy_matches():
    (_, _), (tt, th) = _pair("A")
    part = t_wl.uniform_partition(tt, 4, 4)
    for backend in ("numpy", "torch"):
        r = t_ev.Evaluator(tt, th, congestion="regime", backend=backend,
                           device="cpu").evaluate(part)
        f = t_ev.Evaluator(tt, th, congestion="flow", backend=backend,
                           device="cpu").evaluate(part)
        assert f.latency != pytest.approx(r.latency, rel=1e-6)
        assert f.energy == pytest.approx(r.energy, rel=1e-12)


def test_flow_equals_regime_on_type_c():
    """Type C stacks memory on every chiplet: no data touches the mesh,
    so flow == regime exactly, on both backends."""
    (_, _), (tt, th) = _pair("C")
    part = t_wl.uniform_partition(tt, 4, 4)
    for backend in ("numpy", "torch"):
        r = t_ev.Evaluator(tt, th, congestion="regime", backend=backend,
                           device="cpu").evaluate(part)
        f = t_ev.Evaluator(tt, th, congestion="flow", backend=backend,
                           device="cpu").evaluate(part)
        assert f.latency == pytest.approx(r.latency, rel=1e-12)
        np.testing.assert_allclose(f.t_in, r.t_in, rtol=1e-12)
        np.testing.assert_allclose(f.t_out, r.t_out, rtol=1e-12)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_eval_sweep_congestion_axis(backend):
    """EvalPoints on a congestion axis (two shapes, both modes) batch,
    cache per mode, and match JAX's numpy sweep; a regime point keeps
    its key whether the mode is spelled out or not."""
    rtol = EXACT if backend == "numpy" else TORCH
    grids = ((("A", 4), ("B", 4), ("A", 2)))
    pts = {}
    for pkg in ("jax", "torch"):
        ev, hw, sweep, _ = PKGS[pkg]
        pts[pkg] = [sweep.EvalPoint(toy_task(pkg), hw.make_hw(t, g, "hbm"),
                                    ev.EvalOptions(congestion=c))
                    for t, g in grids for c in ("regime", "flow")]
    want = j_sweep.eval_sweep(pts["jax"], backend="numpy")
    recs = t_sweep.eval_sweep(pts["torch"], backend=backend, device="cpu")
    assert t_sweep.cache_stats() == {"hits": 0, "misses": 6}
    for w, r in zip(want, recs):
        for k in KEYS:
            np.testing.assert_allclose(r[k], w[k], rtol=rtol, err_msg=k)
    again = t_sweep.eval_sweep(pts["torch"], backend=backend, device="cpu")
    assert t_sweep.cache_stats() == {"hits": 6, "misses": 6}
    assert again[0]["latency"] != again[1]["latency"]
    implicit = t_sweep.EvalPoint(toy_task("torch"),
                                 t_hw.make_hw("A", 4, "hbm"))
    t_sweep.eval_sweep([implicit], backend=backend, device="cpu")
    assert t_sweep.cache_stats() == {"hits": 7, "misses": 6}
    key = t_sweep._backend_key(backend, "cpu")
    assert t_sweep._point_fingerprint(implicit, key) == \
        t_sweep._point_fingerprint(pts["torch"][0], key)


def test_eval_sweep_flow_launches_once_per_group_on_the_op():
    """On the CPU the torch evaluator sends a whole flow group to the
    waterfilling op (its plain version here): the kernel counter stays
    at 0, and the group's records equal their solo evaluations."""
    (_, _), (tt, th) = _pair("A")
    pts = [t_sweep.EvalPoint(tt, t_hw.make_hw("A", 4, m),
                             t_ev.EvalOptions(congestion="flow"))
           for m in ("hbm", "dram")]
    nk.waterfill.launches = 0
    recs = t_sweep.eval_sweep(pts, backend="torch", device="cpu",
                              cache=False)
    assert nk.waterfill.launches == 0
    for pt, rec in zip(pts, recs):
        solo = t_sweep.eval_sweep([pt], backend="torch", device="cpu",
                                  cache=False)[0]
        for k in KEYS:
            np.testing.assert_array_equal(solo[k], rec[k], err_msg=k)


FLOW_GA = dict(generations=2, population=8, patience=2, seed=0)


def _flow_points(pkg):
    ev, hw, sweep, _ = PKGS[pkg]
    opts = ev.EvalOptions(redistribution=True, async_exec=True,
                          congestion="flow")
    return [sweep.EvalPoint(toy_task(pkg, 2), hw.make_hw("A", 2, "hbm"),
                            opts)]


@pytest.mark.parametrize("engine", ["python", "vectorized"])
def test_solve_grid_under_flow_numpy_engines_equal_jax(engine):
    """The JAX suite's GA-under-flow case on the host engines: the same
    records as JAX's, bit for bit; the second call hits the cache."""
    cfg_j = j_ga.GAConfig(engine=engine, **FLOW_GA)
    cfg_t = t_ga.GAConfig(engine=engine, **FLOW_GA)
    want = j_sweep.solve_grid(_flow_points("jax"), "latency", cfg_j,
                              backend="numpy")[0]
    got = t_sweep.solve_grid(_flow_points("torch"), "latency", cfg_t,
                             backend="numpy")[0]
    assert np.isfinite(got.objective) and got.objective > 0
    assert got.objective == want.objective
    np.testing.assert_array_equal(got.history, want.history)
    np.testing.assert_array_equal(got.partition.Px, want.partition.Px)
    np.testing.assert_array_equal(got.partition.Py, want.partition.Py)
    np.testing.assert_array_equal(got.redist_mask, want.redist_mask)
    assert t_sweep.cache_stats()["misses"] >= 1
    again = t_sweep.solve_grid(_flow_points("torch"), "latency", cfg_t,
                               backend="numpy")
    assert t_sweep.cache_stats()["hits"] >= 1
    assert again[0].objective == got.objective


def test_solve_grid_under_flow_device_engine():
    """The device GA (on the CPU) under flow: finite, cached, and its
    record scores the same under JAX's numpy evaluator."""
    cfg = t_ga.GAConfig(engine="vectorized", backend="torch", device="cpu",
                        **FLOW_GA)
    pts = _flow_points("torch")
    rec = t_sweep.solve_grid(pts, "latency", cfg, backend="torch")[0]
    assert np.isfinite(rec.objective) and rec.objective > 0
    again = t_sweep.solve_grid(pts, "latency", cfg, backend="torch")
    assert t_sweep.cache_stats()["hits"] >= 1
    assert again[0].objective == rec.objective
    jpt = _flow_points("jax")[0]
    part = j_wl.Partition(rec.partition.Px, rec.partition.Py,
                          rec.partition.collectors)
    score = j_ev.Evaluator(jpt.task, jpt.hw, jpt.options).evaluate(
        part, rec.redist_mask).latency
    assert rec.objective == pytest.approx(score, rel=TORCH)


def test_segments_flow_equal_jax():
    """A MIQP schedule of the toy task in both packages (numpy lattice),
    re-scored under flow: segments at rtol 1e-12 on numpy and 1e-9 on
    the torch backend, and its flow pipelining equal to JAX's."""
    scheds = {}
    for pkg, api, miqp in (("jax", j_api, j_miqp), ("torch", t_api, t_miqp)):
        _, hw, _, _ = PKGS[pkg]
        scheds[pkg] = api.optimize(toy_task(pkg), hw.make_hw("A", 4, "hbm"),
                                   "miqp", miqp_config=miqp.MIQPConfig(
                                       backend="numpy"))
    want, got = scheds["jax"], scheds["torch"]
    np.testing.assert_array_equal(got.partition.Px, want.partition.Px)
    w = np.array([s[1:] for s in want.segments("flow")])
    assert w.shape == (3, 3)
    assert not np.allclose(w, np.array([s[1:] for s in want.segments()]))
    for backend, rtol in (("numpy", EXACT), ("torch", TORCH)):
        sched = dataclasses.replace(got, backend=backend, device="cpu")
        g = np.array([s[1:] for s in sched.segments("flow")])
        np.testing.assert_allclose(g, w, rtol=rtol)
    assert got.segments("regime") == got.segments()
    pw = want.pipeline(4, congestion="flow")
    pg = got.pipeline(4, congestion="flow")
    assert pg.pipelined == pytest.approx(pw.pipelined, rel=EXACT)
    assert pg.speedup == pytest.approx(pw.speedup, rel=EXACT)
