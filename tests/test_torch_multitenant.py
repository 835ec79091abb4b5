"""The port's multi-tenant placement (``repro_torch.core.multitenant``,
``sweep.multitenant_sweep``) against the JAX package's
(``repro.core.multitenant``, DESIGN.md §18), on tasks and hetero MCMs
built in each package from the same numbers. The JAX package runs on its
numpy engines (its JAX backends need ``jax.experimental.enable_x64``,
which jax 0.9 lacks: ROADMAP.md).

Contracts: band enumeration, the even split and region decode equal
JAX's; tenant demands and contention slowdowns bit for bit; the numpy
backend's solves equal JAX numpy's at rtol 1e-12 (the vectorized GA bit
for bit); on the torch backend (CPU) every contention simulation of a
solve is ONE call of the batched waterfilling op whose slowdowns equal
the numpy engine's bit for bit, scores within 1e-9 (the MIQP inner
engine under the tie contract); the JAX suite's search invariants
(tests/test_hetero_multitenant.py) hold on the torch backend."""
import dataclasses

import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
from repro import graphs as j_graphs
from repro.core import ga as j_ga
from repro.core import hw as j_hw
from repro.core import miqp as j_miqp
from repro.core import multitenant as j_mt
from repro.core import sweep as j_sweep
from repro.core import workload as j_wl
from repro_torch import graphs as t_graphs
from repro_torch.core import evaluator as t_ev
from repro_torch.core import ga as t_ga
from repro_torch.core import hw as t_hw
from repro_torch.core import miqp as t_miqp
from repro_torch.core import multitenant as t_mt
from repro_torch.core import sweep as t_sweep
from repro_torch.core import workload as t_wl
from repro_torch.kernels.netsim import ops as netsim_ops

PKGS = {"jax": (j_ga, j_hw, j_miqp, j_mt, j_sweep, j_wl, j_graphs),
        "torch": (t_ga, t_hw, t_miqp, t_mt, t_sweep, t_wl, t_graphs)}
RTOL = 1e-12
TORCH_RTOL = 1e-9
GA = dict(population=16, generations=4, patience=2, seed=0)
MIQP = dict(engine="lattice", candidate_budget=256, eval_budget=1024,
            beam_width=4, refine_sweeps=1, pair_refine=4, descent_sweeps=2,
            score_chunk=256)


@pytest.fixture(autouse=True)
def _fresh_cache():
    t_sweep.clear_cache()
    j_sweep.clear_cache()
    yield
    t_sweep.clear_cache()
    j_sweep.clear_cache()


def toy_task(pkg, n=3, m=512, name=None):
    """The JAX multi-tenant suite's task."""
    wl = PKGS[pkg][5]
    ops = [wl.GemmOp("g0", M=m, K=256, N=512)]
    for i in range(1, n):
        ops.append(wl.GemmOp(f"g{i}", M=m, K=ops[-1].N, N=512,
                             chained=True))
    return wl.Task(name or f"toy{n}_{m}", ops)


def two_class_hw(pkg, **kw):
    """The JAX suite's asymmetric grid: fast top half, slow bottom."""
    hw = PKGS[pkg][1]
    fast = hw.ChipletClass("fast", freq_hz=2e9, bw_nop=120e9)
    slow = hw.ChipletClass("slow", freq_hz=0.5e9, bw_nop=30e9,
                           mem_scale=0.5)
    base = hw.HWConfig(**kw)
    half = base.X * base.Y // 2
    return hw.HWConfig.hetero([fast, slow], [0] * half + [1] * half, **kw)


def fig_hetero_two_class(pkg):
    """``benchmarks/fig_hetero.py``'s two-class 4x4 type-A HBM grid."""
    hw = PKGS[pkg][1]
    fast = hw.ChipletClass("fast", freq_hz=1.5e9, bw_nop=120e9)
    slow = hw.ChipletClass("slow", freq_hz=0.5e9, bw_nop=30e9,
                           mem_scale=0.5)
    return dataclasses.replace(hw.make_hw("A", 4, "hbm"),
                               chiplet_classes=(fast, slow),
                               class_assignment=(0,) * 8 + (1,) * 8)


def tenants(pkg):
    return [toy_task(pkg, 2, 256, "tenant_a"),
            toy_task(pkg, 3, 512, "tenant_b")]


def hw_state(hw):
    """Every HWConfig field, chiplet classes as plain tuples, so configs
    of the two packages compare by value."""
    out = []
    for f in dataclasses.fields(hw):
        v = getattr(hw, f.name)
        if f.name == "chiplet_classes" and v is not None:
            v = tuple(dataclasses.astuple(c) for c in v)
        elif f.name == "mcm_type":
            v = v.value
        out.append((f.name, v))
    return tuple(out)


def assert_same_result(a, b, rtol=RTOL):
    assert a.assignment == b.assignment
    for f in ("objective", "latency", "energy", "edp"):
        np.testing.assert_allclose(getattr(b, f), getattr(a, f), rtol=rtol,
                                   err_msg=f)
    for pa, pb in zip(a.partitions, b.partitions):
        np.testing.assert_array_equal(pa.Px, pb.Px)
        np.testing.assert_array_equal(pa.Py, pb.Py)
    for da, db in zip(a.per_tenant, b.per_tenant):
        assert da["slowdown"] == db["slowdown"]
        for k in ("latency", "energy", "edp"):
            np.testing.assert_allclose(db[k], da[k], rtol=rtol, err_msg=k)
    assert a.baseline["assignment"] == b.baseline["assignment"]
    np.testing.assert_allclose(b.baseline["edp"], a.baseline["edp"],
                               rtol=rtol)
    assert a.evaluations == b.evaluations


def count_waterfill(monkeypatch):
    """Count the calls of the batched waterfilling op, keeping their
    ``msgs`` and ``done``."""
    calls = []
    real = netsim_ops.waterfill

    def spy(caps, inc, msgs, routes=None, link_bytes=True):
        out = real(caps, inc, msgs, routes=routes, link_bytes=link_bytes)
        calls.append((msgs, out[1]))
        return out

    monkeypatch.setattr(netsim_ops, "waterfill", spy)
    return calls


# ----------------------------------------------------- tenant geometry
@settings(max_examples=25, deadline=None)
@given(st.integers(1, 8), st.integers(1, 8), st.integers(1, 40))
def test_band_assignments_equal_jax(X, T, cap):
    if T > X:
        for mt in (j_mt, t_mt):
            with pytest.raises(ValueError):
                mt.band_assignments(X, T, cap)
        return
    got = t_mt.band_assignments(X, T, cap)
    assert got == j_mt.band_assignments(X, T, cap)
    assert t_mt.even_split_assignment(X, T) in got
    assert 1 <= len(got) <= cap


def test_even_split_and_region_hw_equal_jax():
    for X in range(1, 9):
        for T in range(1, X + 1):
            assert (t_mt.even_split_assignment(X, T)
                    == j_mt.even_split_assignment(X, T))
    for make in (two_class_hw, fig_hetero_two_class,
                 lambda p: PKGS[p][1].make_hw("B", 8, "hbm")):
        jh, th = make("jax"), make("torch")
        for x0, x1 in ((0, 1), (0, 2), (1, 4), (2, 4), (0, 4)):
            assert hw_state(t_mt.region_hw(th, x0, x1)) == \
                hw_state(j_mt.region_hw(jh, x0, x1))
        with pytest.raises(ValueError):
            t_mt.region_hw(th, 3, 3)


# ---------------------------------------------------------- contention
HWS = {"two_class": two_class_hw,
       "fig_hetero": fig_hetero_two_class,
       "A8": lambda p: PKGS[p][1].make_hw("A", 8, "hbm"),
       "B8": lambda p: PKGS[p][1].make_hw("B", 8, "hbm", bw_nop=64.0)}


def tenant_set(pkg, T):
    return [toy_task(pkg, 2 + i % 2, 256 * (i + 1), f"t{i}")
            for i in range(T)]


@pytest.mark.parametrize("name,T,cap", [("two_class", 2, 64),
                                        ("fig_hetero", 2, 64),
                                        ("A8", 3, 8), ("B8", 4, 6)])
def test_demand_and_slowdowns_bitwise_jax(name, T, cap):
    jh, th = HWS[name]("jax"), HWS[name]("torch")
    jt, tt = tenant_set("jax", T), tenant_set("torch", T)
    for a in j_mt.band_assignments(jh.X, T, cap):
        for jtask, ttask, band in zip(jt, tt, a):
            np.testing.assert_array_equal(
                t_mt._tenant_demand(ttask, band, th),
                j_mt._tenant_demand(jtask, band, jh))
        np.testing.assert_array_equal(
            t_mt._contention_slowdowns(tt, a, th),
            j_mt._contention_slowdowns(jt, a, jh))


@pytest.mark.parametrize("name,T,cap", [("two_class", 2, 64),
                                        ("A8", 3, 8), ("B8", 4, 6)])
def test_batched_slowdowns_one_call_bitwise_numpy(name, T, cap,
                                                  monkeypatch):
    """Every simulation of every assignment in ONE call of the batched
    op (its plain version on the CPU), slowdowns equal to the numpy
    engine's per-assignment loop bit for bit; flows outside a tenant's
    band carry 0 bytes and end with done = 0."""
    th = HWS[name]("torch")
    tt = tenant_set("torch", T)
    asg = t_mt.band_assignments(th.X, T, cap)
    calls = count_waterfill(monkeypatch)
    got = t_mt._contention_slowdowns_batch(tt, asg, th, device="cpu")
    assert len(calls) == 1
    msgs, done = calls[0]
    assert msgs.shape[:2] == (1, len(asg) * (T + 1))
    zero = msgs == 0
    assert bool(zero.any()) and bool((done[zero] == 0).all())
    want = np.stack([t_mt._contention_slowdowns(tt, a, th) for a in asg])
    np.testing.assert_array_equal(got, want)
    assert (got >= 1.0).all()


def test_batched_slowdowns_skip_tenants_without_bytes(monkeypatch):
    """JAX's host early outs: a tenant whose band is all routeless adds
    no simulation, an assignment with no joint bytes none at all."""
    th = t_hw.make_hw("A", 2, "hbm")
    tt = tenant_set("torch", 2)
    asg = t_mt.band_assignments(th.X, 2)
    calls = count_waterfill(monkeypatch)
    got = t_mt._contention_slowdowns_batch(tt, asg, th, device="cpu")
    want = np.stack([t_mt._contention_slowdowns(tt, a, th) for a in asg])
    np.testing.assert_array_equal(got, want)
    _, dist_inc, _ = th.topology.flow_net()
    routed = dist_inc.sum(axis=1) > 0
    n_sims = sum(1 + sum((t_mt._tenant_demand(t, b, th) * routed).any()
                         for t, b in zip(tt, a))
                 for a in asg
                 if any((t_mt._tenant_demand(t, b, th) * routed).any()
                        for t, b in zip(tt, a)))
    assert sum(m.shape[1] for m, _ in calls) == n_sims


# ---------------------------------------------- solves: port vs JAX numpy
def solve(pkg, method, cfg=None, hw=two_class_hw, tasks=tenants,
          backend="numpy", **kw):
    ga, _, miqp, mt, _, _, _ = PKGS[pkg]
    inner = {"ga": lambda: ga.GAConfig(**GA),
             "miqp": lambda: miqp.MIQPConfig(**MIQP),
             "uniform": lambda: None}[method]()
    return mt.solve_multitenant(
        tasks(pkg), hw(pkg), objective="edp",
        cfg=mt.MultiTenantConfig(method=method, cfg=inner),
        backend=backend, **kw)


@pytest.mark.parametrize("method", ["uniform", "ga", "miqp"])
def test_solve_multitenant_numpy_equals_jax(method):
    assert_same_result(solve("jax", method), solve("torch", method))


def test_fig_hetero_two_tenants_uniform_equals_jax():
    """fig_hetero's multi-tenant leg (AlexNet + ViT-B/16 on the two-class
    4x4 grid, uniform inner solves) through both packages."""
    def pair(pkg):
        w = PKGS[pkg][6].WORKLOADS
        return [w["alexnet"](batch=1), w["vit"](batch=1)]

    want = solve("jax", "uniform", hw=fig_hetero_two_class, tasks=pair)
    got = solve("torch", "uniform", hw=fig_hetero_two_class, tasks=pair)
    assert_same_result(want, got)
    assert got.assignment == ((0, 1), (1, 4))
    tgot = solve("torch", "uniform", hw=fig_hetero_two_class, tasks=pair,
                 backend="torch", device="cpu")
    assert_same_result(got, tgot, rtol=TORCH_RTOL)


# -------------------------------------------------- torch backend (CPU)
def test_torch_uniform_within_1e9_and_one_contention_call(monkeypatch):
    want = solve("torch", "uniform")
    calls = count_waterfill(monkeypatch)
    got = solve("torch", "uniform", backend="torch", device="cpu")
    assert len(calls) == 1
    assert_same_result(want, got, rtol=TORCH_RTOL)


def test_torch_miqp_within_the_tie_contract():
    """The lattice scores on the torch evaluator: the objective within
    1e-9 of numpy's; a partition that differs is a tie, re-scored by the
    JAX numpy evaluator within 1e-9 of numpy's."""
    want = solve("jax", "miqp")
    got = solve("torch", "miqp", backend="torch", device="cpu")
    np.testing.assert_allclose(got.objective, want.objective,
                               rtol=TORCH_RTOL)
    if got.assignment == want.assignment:
        for da, db in zip(want.per_tenant, got.per_tenant):
            assert da["slowdown"] == db["slowdown"]
            np.testing.assert_allclose(db["edp"], da["edp"],
                                       rtol=TORCH_RTOL)


def test_torch_search_invariants():
    """The JAX suite's invariants on the torch backend: never worse than
    the even split, strictly better on the asymmetric grid, scores
    composed as max/sum, host floats, slowdowns >= 1."""
    res = solve("torch", "uniform", backend="torch", device="cpu")
    assert res.objective <= res.baseline["edp"]
    assert res.objective == res.edp == res.energy * res.latency
    assert res.latency == max(d["latency"] for d in res.per_tenant)
    assert res.energy == sum(d["energy"] for d in res.per_tenant)
    assert all(d["slowdown"] >= 1.0 for d in res.per_tenant)
    for d in (*res.per_tenant, res.baseline):
        for k, v in d.items():
            if k != "assignment":
                assert type(v) is float, (k, type(v))
    assert res.objective < res.baseline["edp"]
    assert res.assignment != res.baseline["assignment"]


def test_torch_ga_inner_engine_searches_inside_bands():
    res = solve("torch", "ga", backend="torch", device="cpu",
                tasks=lambda p: [toy_task(p, 2, 256, "ga_a"),
                                 toy_task(p, 2, 512, "ga_b")])
    assert res.objective <= res.baseline["edp"]
    assert res.evaluations > 0
    for part, (x0, x1) in zip(res.partitions, res.assignment):
        assert part.Px.shape[1] == (x1 - x0)


def test_contention_off_skips_the_netsim(monkeypatch):
    calls = count_waterfill(monkeypatch)
    res = t_mt.solve_multitenant(
        tenants("torch"), two_class_hw("torch"),
        cfg=t_mt.MultiTenantConfig(method="uniform", contention=False),
        backend="torch", device="cpu")
    assert not calls
    assert all(d["slowdown"] == 1.0 for d in res.per_tenant)


# --------------------------------------------------------------- sweeps
def test_multitenant_sweep_caches_copies():
    pts = [t_sweep.MultiTenantPoint(
        (toy_task("torch", 2, 256), toy_task("torch", 2, 512)),
        two_class_hw("torch"))]
    cfg = t_mt.MultiTenantConfig(method="uniform")
    r1, = t_sweep.multitenant_sweep(pts, cfg=cfg, device="cpu")
    before = t_sweep.cache_stats()
    r2, = t_sweep.multitenant_sweep(pts, cfg=cfg, device="cpu")
    assert t_sweep.cache_stats()["hits"] > before["hits"]
    assert (r1.objective, r1.assignment) == (r2.objective, r2.assignment)
    r2.baseline["edp"] = -1.0          # returned records are copies
    r2.partitions[0].Px[:] = 0
    r3, = t_sweep.multitenant_sweep(pts, cfg=cfg, device="cpu")
    assert r3.baseline["edp"] == r1.baseline["edp"]
    np.testing.assert_array_equal(r3.partitions[0].Px, r1.partitions[0].Px)
    # numpy and torch records are cached apart
    t_sweep.multitenant_sweep(pts, cfg=cfg, backend="numpy")
    keys = {k[1] for k in t_sweep.export_cache() if k[0] == "multitenant"}
    assert keys == {"numpy", ("torch", "cpu")}


def test_solve_grid_routes_multitenant():
    pts = [t_sweep.MultiTenantPoint((toy_task("torch", 2, 256),),
                                    t_hw.HWConfig(X=2))]
    rec, = t_sweep.solve_grid(pts, objective="edp",
                              cfg=t_mt.MultiTenantConfig(method="uniform"),
                              method="multitenant", device="cpu")
    assert isinstance(rec, t_mt.MultiTenantResult)
    want, = j_sweep.solve_grid(
        [j_sweep.MultiTenantPoint((toy_task("jax", 2, 256),),
                                  j_hw.HWConfig(X=2))],
        objective="edp", cfg=j_mt.MultiTenantConfig(method="uniform"),
        method="multitenant", backend="numpy")
    assert_same_result(want, rec, rtol=TORCH_RTOL)


def test_solve_multitenant_rejects_bad_inputs():
    hw = t_hw.HWConfig()
    with pytest.raises(ValueError, match="objective"):
        t_mt.solve_multitenant([toy_task("torch", 2)], hw,
                               objective="speed")
    with pytest.raises(ValueError, match="at least one"):
        t_mt.solve_multitenant([], hw)
    with pytest.raises(ValueError, match="row"):
        t_mt.solve_multitenant([toy_task("torch", 2)] * 5, hw)
    with pytest.raises(ValueError, match="unknown tenant method"):
        t_mt.MultiTenantConfig(method="annealing")
    with pytest.raises(ValueError, match="max_assignments"):
        t_mt.MultiTenantConfig(max_assignments=0)
    with pytest.raises(ValueError, match="backend"):
        t_mt.solve_multitenant([toy_task("torch", 2)], hw, backend="jax")
    with pytest.raises(TypeError, match="MultiTenantConfig"):
        t_sweep.multitenant_sweep([], cfg=t_ga.GAConfig())
    opts = t_ev.EvalOptions()
    assert opts.devices == "auto"


def test_cosearch_inner_engine_names_a5():
    """The co-search inner engine (torch backend on the CPU; the JAX
    package's co-search has no numpy engine either): a two-tenant solve
    equals its decode — the winning assignment's co-search records,
    each diag gene folded into its tenant's hardware — scored by the
    numpy evaluator under the same contention, at rtol 1e-9."""
    from repro_torch.core.cosearch import CoSearchConfig

    tasks, hw = tenants("torch"), two_class_hw("torch")
    inner = CoSearchConfig(population=16, generations=4, patience=4,
                           seed_steps=2, seed_starts=2, archive_size=4,
                           device="cpu")
    cfg = t_mt.MultiTenantConfig(method="cosearch", cfg=inner)
    opts = t_ev.EvalOptions()
    res = t_mt.solve_multitenant(tasks, hw, objective="edp", cfg=cfg,
                                 backend="torch", device="cpu")
    assert res.objective <= res.baseline["edp"]
    regions = [t_mt.region_hw(hw, x0, x1) for x0, x1 in res.assignment]
    recs = t_sweep.solve_grid(
        [t_sweep.EvalPoint(t, r, opts) for t, r in zip(tasks, regions)],
        "edp", inner, method="cosearch", device="cpu")
    slows = t_mt._contention_slowdowns(tasks, res.assignment, hw)
    for t, region, rec, s, part, d in zip(tasks, regions, recs, slows,
                                          res.partitions, res.per_tenant):
        dpart, rd, score_hw, _ = t_mt._decode_schedule(rec, "cosearch",
                                                       region)
        assert score_hw.diagonal_links == rec.diagonal
        np.testing.assert_array_equal(dpart.Px, part.Px)
        np.testing.assert_array_equal(dpart.Py, part.Py)
        ev = t_ev.Evaluator(t, score_hw, opts,
                            backend="numpy").evaluate(dpart, rd)
        assert d["slowdown"] == s
        np.testing.assert_allclose(
            [d["latency"], d["energy"]],
            [ev.latency + float(ev.t_in.sum()) * (s - 1.0), ev.energy],
            rtol=TORCH_RTOL)
    with pytest.raises(ValueError, match="torch"):
        t_mt.solve_multitenant(tasks, hw, cfg=cfg, backend="numpy")


def test_torch_backend_needs_a_card_or_cpu():
    """``device=None`` means the card: without one the torch backend
    raises rather than carry on on the host."""
    import torch

    run = lambda: t_mt.solve_multitenant(  # noqa: E731
        tenants("torch"), two_class_hw("torch"),
        cfg=t_mt.MultiTenantConfig(method="uniform"))
    if torch.cuda.is_available():
        assert run().objective > 0
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
