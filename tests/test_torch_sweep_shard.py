"""The port's sweep sharding (``repro_torch.core.sweep_shard``, DESIGN.md
§15) against the JAX suite's contract (tests/test_sweep_shard.py): mode
resolution, ``devices`` validation on EvalOptions and the three solver
configs, sharded == single bit for bit for every engine the JAX package
shards (eval in both congestion modes, GA islands, ``netsim_sweep``,
``pipeline_sweep`` and the MIQP lattice), on meshes of 1, 2 and 3 CPU
"devices" (``use_mesh([cpu] * k)``) with grids of 1, 4 and 5 points so
the row-0 padding runs, and one cache for every mode. The sharded
records are also held to the JAX package's numpy engines, on the same
seeded inputs, at the torch backend's contract (rtol 1e-9)."""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro.core import evaluator as j_ev
from repro.core import hw as j_hw
from repro.core import netsim as j_netsim
from repro.core import sweep as j_sweep
from repro.core import workload as j_wl
from repro_torch.core import evaluator as t_ev
from repro_torch.core import ga as t_ga
from repro_torch.core import hw as t_hw
from repro_torch.core import miqp as t_miqp
from repro_torch.core import multitenant as t_mt
from repro_torch.core import netsim as t_netsim
from repro_torch.core import pipelining as t_pipe
from repro_torch.core import sweep as t_sweep
from repro_torch.core import sweep_shard
from repro_torch.core import workload as t_wl
from repro_torch.core.sweep_shard import (DEVICE_MODES, device_count,
                                          resolve_devices, use_mesh)

PKGS = {"jax": (j_ev, j_hw, j_sweep, j_wl),
        "torch": (t_ev, t_hw, t_sweep, t_wl)}
MESHES = (1, 2, 3)
GRIDS = (1, 4, 5)
RTOL = 1e-9


@pytest.fixture(autouse=True)
def _fresh_cache():
    t_sweep.clear_cache()
    yield
    t_sweep.clear_cache()


def toy_task(wl, n=3, m=512):
    """The JAX shard suite's task."""
    ops = [wl.GemmOp("g0", M=m, K=256, N=512)]
    for i in range(1, n):
        ops.append(wl.GemmOp(f"g{i}", M=m, K=ops[-1].N, N=512,
                             chained=True))
    return wl.Task(f"toy{n}_{m}", ops)


def nop_rates(G, seed=0):
    """Seeded per-point NoP rates (GB/s) shared by both packages."""
    return np.random.default_rng(seed).uniform(48.0, 128.0, G)


def eval_points(pkg, G, congestion):
    ev, hw, sweep, wl = PKGS[pkg]
    task = toy_task(wl)
    return [sweep.EvalPoint(task, hw.make_hw("A", 4, "hbm", bw_nop=b),
                            ev.EvalOptions(redistribution=True,
                                           async_exec=True,
                                           congestion=congestion))
            for b in nop_rates(G)]


def sharded(k, fn):
    with use_mesh(["cpu"] * k):
        return fn()


def assert_same_eval(a, b):
    for key in ("latency", "energy", "edp"):
        assert a[key] == b[key], key
    for key in ("t_in", "t_comp", "t_out"):
        np.testing.assert_array_equal(a[key], b[key])


def assert_same_solver(a, b):
    assert a.objective == b.objective
    np.testing.assert_array_equal(a.partition.Px, b.partition.Px)
    np.testing.assert_array_equal(a.partition.Py, b.partition.Py)
    np.testing.assert_array_equal(a.partition.collectors,
                                  b.partition.collectors)
    np.testing.assert_array_equal(a.redist_mask, b.redist_mask)


# ------------------------------------------------------ mode resolution
def test_resolve_devices_modes():
    assert resolve_devices("single", 100) == "single"
    assert resolve_devices("sharded", 1) == "sharded"   # explicit wins
    want = "sharded" if device_count() > 1 else "single"
    assert resolve_devices("auto", 100) == want
    assert resolve_devices(None, 100) == want           # None == auto
    assert resolve_devices("auto", 1) == "single"       # nothing to shard
    with pytest.raises(ValueError, match="devices"):
        resolve_devices("tpu", 4)
    assert device_count() == torch.cuda.device_count()


def test_mesh_defaults_and_override():
    cpu = torch.device("cpu")
    assert sweep_shard.grid_mesh("cpu") == [cpu]
    with use_mesh(["cpu", "cpu"]) as mesh:
        assert mesh == [cpu, cpu]
        assert sweep_shard.grid_mesh("cpu") == [cpu, cpu]
    assert sweep_shard.grid_mesh("cpu") == [cpu]        # restored
    with pytest.raises(ValueError, match="at least one"):
        with use_mesh([]):
            pass
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sweep_shard.grid_mesh()


@pytest.mark.parametrize("k", MESHES)
@pytest.mark.parametrize("G", GRIDS)
def test_sharded_grid_call_pads_with_row_zero_and_gathers(k, G):
    """Each shard sees equal slices; the padding replicates row 0 (never
    zeros); numpy and tensor leaves, dict trees and replicated args come
    back concatenated in order and sliced to the grid."""
    rng = np.random.default_rng(G)
    a = rng.uniform(1.0, 2.0, (G, 3))
    b = {"t": torch.from_numpy(rng.uniform(1.0, 2.0, (G, 2)))}
    shared = np.arange(4.0)
    seen = []

    def inner(a, b, shared, *, device):
        seen.append((a.shape[0], device))
        assert (a > 0).all() and bool((b["t"] > 0).all())
        np.testing.assert_array_equal(shared, np.arange(4.0))
        return {"a": a * 2.0, "t": b["t"].to(device) + 1.0}

    out = sweep_shard.sharded_grid_call(inner, (a, b, shared),
                                        (True, True, False), G,
                                        mesh=["cpu"] * k)
    per = -(-G // k)
    assert [s for s, _ in seen] == [per] * k
    np.testing.assert_array_equal(out["a"], a * 2.0)
    torch.testing.assert_close(out["t"], b["t"] + 1.0, rtol=0, atol=0)


@pytest.mark.parametrize("k", (2, 3))
def test_shards_are_all_issued_before_any_syncs(k):
    """Every shard runs on a thread of its own: a fake engine that waits
    on a barrier of the whole mesh (as an engine waits for its device)
    only gets through if all shards run at once; run in turn, the first
    would time out. Results come back in mesh order; a failing shard's
    exception is raised, the first in mesh order."""
    barrier = threading.Barrier(k, timeout=5)
    a = np.arange(4.0 * k).reshape(2 * k, 2)

    def inner(x, *, device):
        barrier.wait()
        return {"x": x * 2.0, "thread": np.array(
            [threading.get_ident()] * len(x))}

    out = sweep_shard.sharded_grid_call(inner, (a,), (True,), 2 * k,
                                        mesh=["cpu"] * k)
    np.testing.assert_array_equal(out["x"], a * 2.0)
    assert len(set(out["thread"].tolist())) == k

    def failing(x, *, device):
        if x[0, 0] >= 4.0:
            raise RuntimeError(f"shard at {x[0, 0]:.0f} failed")
        return x

    with pytest.raises(RuntimeError, match="shard at 4 failed"):
        sweep_shard.sharded_grid_call(failing, (a,), (True,), 2 * k,
                                      mesh=["cpu"] * k)


# --------------------------------------------------- devices validation
def test_options_and_configs_validate_devices():
    with pytest.raises(ValueError, match="devices"):
        t_ev.EvalOptions(devices="bogus")
    for mode in DEVICE_MODES:
        assert t_ev.EvalOptions(devices=mode).devices == mode
        # the JAX package's options carry the same field and modes
        assert j_ev.EvalOptions(devices=mode).devices == mode
    assert DEVICE_MODES == j_ev.DEVICE_MODES
    assert t_ga.GAConfig(devices="sharded").devices == "sharded"
    assert t_miqp.MIQPConfig(devices="sharded").devices == "sharded"
    assert t_pipe.PipelineConfig(devices="sharded").devices == "sharded"
    pts = eval_points("torch", 1, "regime")
    with pytest.raises(ValueError, match="devices"):
        t_sweep.solve_grid(pts, "latency", t_ga.GAConfig(
            population=8, generations=1, devices="tpu"), backend="torch",
            device="cpu")
    with pytest.raises(ValueError, match="devices"):
        t_sweep.solve_grid(pts, "latency", t_miqp.MIQPConfig(
            devices="tpu", backend="torch", device="cpu"), method="miqp")
    with pytest.raises(ValueError, match="devices"):
        t_sweep.pipeline_sweep([t_sweep.PipelinePoint(
            [("a", 1.0, 2.0, 1.0)], 2)],
            t_pipe.PipelineConfig(devices="tpu"), device="cpu")


# ----------------------------------------- bitwise parity (all families)
@pytest.mark.parametrize("congestion", ["regime", "flow"])
@pytest.mark.parametrize("k", MESHES)
@pytest.mark.parametrize("G", GRIDS)
def test_eval_sweep_sharded_matches_single_bitwise(congestion, k, G):
    pts = eval_points("torch", G, congestion)
    solo = t_sweep.eval_sweep(pts, cache=False, device="cpu",
                              devices="single")
    shard = sharded(k, lambda: t_sweep.eval_sweep(
        pts, cache=False, device="cpu", devices="sharded"))
    for a, b in zip(solo, shard):
        assert_same_eval(a, b)
    # the options' own devices field is honored when the call defers
    via_opts = [dataclasses.replace(p, options=dataclasses.replace(
        p.options, devices="sharded")) for p in pts]
    for a, b in zip(solo, sharded(k, lambda: t_sweep.eval_sweep(
            via_opts, cache=False, device="cpu"))):
        assert_same_eval(a, b)


@pytest.mark.parametrize("congestion", ["regime", "flow"])
def test_sharded_eval_matches_jax_numpy(congestion):
    """The same seeded points through JAX's numpy evaluator and the
    port's torch evaluator sharded three ways on the CPU."""
    want = j_sweep.eval_sweep(eval_points("jax", 5, congestion),
                              backend="numpy", cache=False)
    got = sharded(3, lambda: t_sweep.eval_sweep(
        eval_points("torch", 5, congestion), cache=False, device="cpu",
        devices="sharded"))
    for a, b in zip(want, got):
        for key in ("latency", "energy", "edp", "t_in", "t_comp", "t_out"):
            np.testing.assert_allclose(b[key], a[key], rtol=RTOL,
                                       err_msg=key)


@pytest.mark.parametrize("k", MESHES)
@pytest.mark.parametrize("G", GRIDS)
def test_solve_grid_ga_sharded_matches_single_bitwise(k, G):
    pts = eval_points("torch", G, "regime")
    cfg = t_ga.GAConfig(population=16, generations=6, patience=3, seed=7,
                        engine="vectorized", backend="torch")
    solo = t_sweep.solve_grid(pts, "latency", cfg, cache=False,
                              device="cpu", devices="single")
    shard = sharded(k, lambda: t_sweep.solve_grid(
        pts, "latency", cfg, cache=False, device="cpu",
        devices="sharded"))
    for a, b in zip(solo, shard):
        assert_same_solver(a, b)
        np.testing.assert_array_equal(a.history, b.history)
        assert a.evaluations == b.evaluations


@pytest.mark.parametrize("k", (2, 3))
def test_ga_islands_at_p64_shard_sizes_that_do_not_divide(k):
    """Five islands at P 64 with early stops: the shards (3+2, 2+2+1)
    stop at their own chunk, the records are the single grid's."""
    pts = eval_points("torch", 5, "regime")
    cfg = t_ga.GAConfig(population=64, generations=16, patience=4, seed=3,
                        engine="vectorized", backend="torch")
    solo = t_sweep.solve_grid(pts, "edp", cfg, cache=False, device="cpu",
                              devices="single")
    shard = sharded(k, lambda: t_sweep.solve_grid(
        pts, "edp", cfg, cache=False, device="cpu", devices="sharded"))
    for a, b in zip(solo, shard):
        assert_same_solver(a, b)
        np.testing.assert_array_equal(a.history, b.history)


@pytest.mark.parametrize("k", MESHES)
@pytest.mark.parametrize("G", GRIDS)
def test_netsim_sweep_sharded_matches_single_bitwise(k, G):
    rates = nop_rates(G, seed=1)
    nets = [t_netsim.MeshNet(4, 4, r, 128.0, [0, 3]) for r in rates]
    solo = t_sweep.netsim_sweep(nets, 1e6, cache=False, device="cpu",
                                devices="single")
    shard = sharded(k, lambda: t_sweep.netsim_sweep(
        nets, 1e6, cache=False, device="cpu", devices="sharded"))
    for r, a, b in zip(rates, solo, shard):
        assert a["latency"] == b["latency"]
        np.testing.assert_array_equal(a["done"], b["done"])
        np.testing.assert_array_equal(a["link_bytes"], b["link_bytes"])
        ref = j_netsim.simulate_flows(
            j_netsim.MeshNet(4, 4, r, 128.0, [0, 3]).pull_incidence(),
            j_netsim.MeshNet(4, 4, r, 128.0, [0, 3]).link_caps(),
            np.full(16, 1e6))
        np.testing.assert_allclose(b["done"], ref["done"], rtol=RTOL)


@pytest.mark.parametrize("k", MESHES)
@pytest.mark.parametrize("G", GRIDS)
def test_pipeline_sweep_sharded_matches_single_bitwise(k, G):
    rng = np.random.default_rng(G)
    pts = [t_sweep.PipelinePoint(
        [(f"op{i}", *rng.uniform(0.1, 2.0, 3)) for i in range(4)], 4)
        for _ in range(G)]
    solo = t_sweep.pipeline_sweep(pts, cache=False, device="cpu",
                                  devices="single")
    shard = sharded(k, lambda: t_sweep.pipeline_sweep(
        pts, cache=False, device="cpu", devices="sharded"))
    for a, b in zip(solo, shard):
        assert (a.sequential, a.pipelined) == (b.sequential, b.pipelined)


@pytest.mark.parametrize("k", MESHES)
def test_solve_grid_miqp_sharded_matches_single_bitwise(k):
    pts = eval_points("torch", 4, "regime")
    cfg = t_miqp.MIQPConfig(candidate_budget=64, eval_budget=256,
                            backend="torch", device="cpu")
    solo = t_sweep.solve_grid(pts, "latency", cfg, cache=False,
                              method="miqp", devices="single")
    shard = sharded(k, lambda: t_sweep.solve_grid(
        pts, "latency", cfg, cache=False, method="miqp",
        devices="sharded"))
    for a, b in zip(solo, shard):
        assert_same_solver(a, b)


def test_multitenant_sweep_sharded_matches_single_bitwise():
    pt = t_sweep.MultiTenantPoint(
        (toy_task(t_wl, 2, 256), toy_task(t_wl, 2, 512)),
        t_hw.make_hw("A", 4, "hbm"))
    cfg = t_mt.MultiTenantConfig(method="ga", cfg=t_ga.GAConfig(
        population=8, generations=3, patience=3, seed=0))
    a, = t_sweep.multitenant_sweep([pt], "edp", cfg, cache=False,
                                   device="cpu", devices="single")
    b, = sharded(2, lambda: t_sweep.multitenant_sweep(
        [pt], "edp", cfg, cache=False, device="cpu", devices="sharded"))
    assert (a.assignment, a.objective, a.per_tenant) == \
        (b.assignment, b.objective, b.per_tenant)


# ----------------------------------------- fingerprints & shared cache
def test_devices_knob_is_fingerprint_invisible():
    task, hw = toy_task(t_wl, 2), t_hw.make_hw("A", 4, "hbm")
    key = ("torch", "cpu")
    fps = {t_sweep._point_fingerprint(
        t_sweep.EvalPoint(task, hw, t_ev.EvalOptions(devices=mode)), key)
        for mode in DEVICE_MODES}
    assert len(fps) == 1
    cfg_fps = {t_sweep._solver_fingerprint(
        t_sweep.EvalPoint(task, hw), "ga", key, "latency",
        t_ga.GAConfig(devices=mode)) for mode in DEVICE_MODES}
    assert len(cfg_fps) == 1
    mt_fps = {t_sweep._multitenant_fingerprint(
        t_sweep.MultiTenantPoint((task,), hw,
                                 t_ev.EvalOptions(devices=mode)),
        key, "edp", t_mt.MultiTenantConfig(
            devices=mode, cfg=t_ga.GAConfig(devices=mode)))
        for mode in DEVICE_MODES}
    assert len(mt_fps) == 1


def test_cache_shared_across_device_modes():
    pts = eval_points("torch", 3, "flow")
    t_sweep.eval_sweep(pts, device="cpu", devices="single")
    assert t_sweep.cache_stats() == {"hits": 0, "misses": 3}
    recs = sharded(2, lambda: t_sweep.eval_sweep(pts, device="cpu",
                                                 devices="sharded"))
    assert t_sweep.cache_stats() == {"hits": 3, "misses": 3}
    assert all(r is not None for r in recs)
    cfg = t_ga.GAConfig(population=8, generations=2, seed=1,
                        engine="vectorized", backend="torch")
    t_sweep.solve_grid(pts, "latency", cfg, device="cpu", devices="auto")
    sharded(3, lambda: t_sweep.solve_grid(pts, "latency", cfg, device="cpu",
                                          devices="sharded"))
    assert t_sweep.cache_stats() == {"hits": 6, "misses": 6}
