"""The port's optimisation server (``repro_torch.serve.optserver``,
``serve/coalesce.py``, DESIGN.md §14) on the CPU: every case of the JAX
suite's server tests (tests/test_serve_optserver.py) and its multi-tenant
firewall cases (tests/test_hetero_multitenant.py), with ``"torch"``
where JAX has ``"jax"`` and the server's ``device="cpu"``; served ==
solo bit for bit for every kind, multi-tenant included; and the whole
slice held to the JAX package: the same numpy-backend requests through
JAX's ``OptServer`` and the port's give equal records. Also the
thread-safe kernel build the server's worker relies on, with ``nvcc``
stubbed. Futures wait at most 30 s: a hang fails fast."""
import asyncio
import os
import pickle
import shutil
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

from repro.core import EvalOptions as JEvalOptions
from repro.core import GemmOp as JGemmOp
from repro.core import MultiTenantConfig as JMultiTenantConfig
from repro.core import Task as JTask
from repro.core import make_hw as j_make_hw
from repro.core import sweep as j_sweep
from repro.core.ga import GAConfig as JGAConfig
from repro.core.pipelining import PipelineConfig as JPipelineConfig
from repro.serve import OptRequest as JOptRequest
from repro.serve import OptServer as JOptServer
from repro_torch.core import (ChipletClass, EvalOptions, GemmOp, HWConfig,
                              MultiTenantConfig, Task, make_hw)
from repro_torch.core import sweep
from repro_torch.core.ga import GAConfig
from repro_torch.core.miqp import MIQPConfig
from repro_torch.core.pipelining import PipelineConfig
from repro_torch.core.workload import uniform_partition
from repro_torch.runtime import StragglerMonitor
from repro_torch.serve import (BadRequest, OptRequest, OptServer,
                               ServerOverloaded)
from repro_torch.serve.coalesce import group_requests

WAIT = 30


def toy_task(n=3, m=512, name=None, gemm=GemmOp, task=Task):
    ops = [gemm("g0", M=m, K=256, N=512)]
    for i in range(1, n):
        ops.append(gemm(f"g{i}", M=m, K=ops[-1].N, N=512, chained=True))
    return task(name or f"toy{n}_{m}", ops)


def two_class_hw(**kw):
    fast = ChipletClass("fast", freq_hz=2e9, bw_nop=120e9)
    slow = ChipletClass("slow", freq_hz=0.5e9, bw_nop=30e9, mem_scale=0.5)
    hw = HWConfig(**kw)
    half = hw.X * hw.Y // 2
    return HWConfig.hetero([fast, slow], [0] * half + [1] * half, **kw)


HW = make_hw("A", 2, "hbm")
GA_CFG = GAConfig(generations=4, population=16, patience=4, seed=3)
MIQP_CFG = MIQPConfig(engine="lattice", candidate_budget=256,
                      eval_budget=1024, beam_width=4, refine_sweeps=1,
                      pair_refine=4, descent_sweeps=2, score_chunk=256)
MT_CFG = MultiTenantConfig(method="uniform")
SEGS = [("a", 1.0, 2.0, 1.0), ("b", 0.5, 1.0, 0.5), ("c", 0.2, 0.8, 0.3)]


@pytest.fixture(autouse=True)
def _fresh_cache():
    sweep.clear_cache()
    j_sweep.clear_cache()
    yield
    sweep.clear_cache()
    j_sweep.clear_cache()


def server(**kw):
    kw.setdefault("autostart", False)
    return OptServer(device="cpu", **kw)


def _result_equal(a, b):
    if isinstance(a, dict):                      # eval record
        assert a["latency"] == b["latency"]
        assert a["energy"] == b["energy"]
        assert a["edp"] == b["edp"]
        np.testing.assert_array_equal(a["t_in"], b["t_in"])
        np.testing.assert_array_equal(a["t_out"], b["t_out"])
        return
    if hasattr(a, "pipelined"):                  # PipelineResult
        assert (a.batch, a.sequential, a.pipelined) == \
            (b.batch, b.sequential, b.pipelined)
        return
    if hasattr(a, "assignment"):                 # MultiTenantResult
        assert (a.assignment, a.objective, a.baseline["edp"]) == \
            (b.assignment, b.objective, b.baseline["edp"])
        assert [d["slowdown"] for d in a.per_tenant] == \
            [d["slowdown"] for d in b.per_tenant]
        for pa, pb in zip(a.partitions, b.partitions):
            np.testing.assert_array_equal(pa.Px, pb.Px)
        return
    assert a.objective == b.objective            # GAResult / MIQPResult
    np.testing.assert_array_equal(a.partition.Px, b.partition.Px)
    np.testing.assert_array_equal(a.partition.Py, b.partition.Py)
    np.testing.assert_array_equal(a.redist_mask, b.redist_mask)


# ------------------------------------------------------ solo == served
def _eval_requests(backend):
    task = toy_task()
    reqs = []
    for cong in ("regime", "flow"):
        for redist in (False, True):
            opts = EvalOptions(redistribution=redist, async_exec=True,
                               congestion=cong)
            reqs.append(OptRequest(
                "eval", sweep.EvalPoint(task, HW, opts),
                backend=backend))
    return reqs


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_served_eval_bit_identical_to_solo(backend):
    """N concurrent same-shape eval requests (both congestion modes)
    coalesce into ONE batched call yet return bit-identical records to
    solo ``eval_sweep`` calls — the solo==served contract."""
    reqs = _eval_requests(backend)
    solo = [sweep.eval_sweep([r.point], backend=backend, cache=False,
                             device="cpu")[0] for r in reqs]
    sweep.clear_cache()
    srv = server()
    futs = [srv.submit(r) for r in reqs]
    srv.start()                       # all queued → one worker batch
    recs = [f.result(timeout=WAIT) for f in futs]
    for s, r in zip(solo, recs):
        _result_equal(s, r)
    st = srv.stats()
    assert st["completed"] == len(reqs)
    assert st["batches"] == 1
    assert st["coalesce_factor"] == len(reqs)
    srv.kill()


@pytest.mark.parametrize("method,cfg,backend", [
    ("ga", GA_CFG, "numpy"),
    ("ga", GA_CFG, "torch"),
    ("miqp", MIQP_CFG, "torch"),
])
def test_served_solve_bit_identical_to_solo(method, cfg, backend):
    pts = [sweep.EvalPoint(toy_task(2), HW),
           sweep.EvalPoint(toy_task(2, 256), HW)]
    reqs = [OptRequest("solve", pt, objective="latency", method=method,
                       cfg=cfg, backend=backend) for pt in pts]
    solo = [sweep.solve_grid([pt], "latency", cfg, backend=backend,
                             cache=False, method=method, device="cpu")[0]
            for pt in pts]
    sweep.clear_cache()
    srv = server()
    futs = [srv.submit(r) for r in reqs]
    srv.start()
    recs = [f.result(timeout=WAIT) for f in futs]
    for s, r in zip(solo, recs):
        _result_equal(s, r)
    srv.kill()


@pytest.mark.parametrize("engine", ["python", "vectorized"])
def test_served_pipeline_bit_identical_to_solo(engine):
    cfg = PipelineConfig(engine=engine)
    pts = [sweep.PipelinePoint(SEGS, b) for b in (2, 4, 8)]
    reqs = [OptRequest("pipeline", pt, cfg=cfg) for pt in pts]
    solo = [sweep.pipeline_sweep([pt], cfg, cache=False, device="cpu")[0]
            for pt in pts]
    sweep.clear_cache()
    srv = server()
    futs = [srv.submit(r) for r in reqs]
    srv.start()
    recs = [f.result(timeout=WAIT) for f in futs]
    for s, r in zip(solo, recs):
        _result_equal(s, r)
    srv.kill()


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_served_multitenant_bit_identical_to_solo(backend):
    pts = [sweep.MultiTenantPoint(
        (toy_task(2, 256, "ta"), toy_task(3, 512, "tb")), two_class_hw()),
        sweep.MultiTenantPoint((toy_task(2, 256, "tc"),), HW)]
    reqs = [OptRequest("solve", pt, objective="edp", method="multitenant",
                       cfg=MT_CFG, backend=backend) for pt in pts]
    solo = [sweep.multitenant_sweep([pt], "edp", MT_CFG, backend=backend,
                                    cache=False, device="cpu")[0]
            for pt in pts]
    sweep.clear_cache()
    srv = server()
    futs = [srv.submit(r) for r in reqs]
    srv.start()
    recs = [f.result(timeout=WAIT) for f in futs]
    for s, r in zip(solo, recs):
        _result_equal(s, r)
    assert srv.stats()["batches"] == 1
    srv.kill()


def test_mixed_kind_traffic_coalesces_per_call_key():
    """A mixed batch (eval + solve + pipeline) groups into exactly one
    sweep call per CallKey, results all correct."""
    ereqs = _eval_requests("torch")[:2]
    preqs = [OptRequest("pipeline", sweep.PipelinePoint(SEGS, b))
             for b in (2, 4)]
    sreqs = [OptRequest("solve", sweep.EvalPoint(toy_task(2), HW),
                        cfg=GA_CFG, backend="numpy")]
    reqs = ereqs + preqs + sreqs
    assert len(group_requests(reqs)) == 3
    srv = server()
    futs = [srv.submit(r) for r in reqs]
    srv.start()
    for f in futs:
        f.result(timeout=WAIT)
    st = srv.stats()
    assert st["batches"] == 3
    assert st["completed"] == len(reqs)
    assert st["coalesce_factor"] == pytest.approx(len(reqs) / 3)
    srv.kill()


def test_submit_async_serves_one_request():
    srv = server(autostart=True)
    req = OptRequest("eval", sweep.EvalPoint(toy_task(), HW))
    rec = asyncio.run(asyncio.wait_for(srv.submit_async(req), WAIT))
    _result_equal(sweep.eval_sweep([req.point], cache=False,
                                   device="cpu")[0], rec)
    srv.kill()


# -------------------------------------------------------- backpressure
def test_bounded_queue_backpressure():
    srv = server(max_queue=3)
    req = lambda: OptRequest("eval", sweep.EvalPoint(toy_task(), HW))  # noqa: E731
    futs = [srv.submit_nowait(req()) for _ in range(3)]
    with pytest.raises(ServerOverloaded):
        srv.submit_nowait(req())
    with pytest.raises(ServerOverloaded):
        srv.submit(req(), timeout=0.01)
    # Backpressure clears once the worker drains the queue.
    srv.start()
    for f in futs:
        f.result(timeout=WAIT)
    srv.submit(req()).result(timeout=WAIT)
    assert srv.stats()["completed"] == 4
    srv.kill()


# ------------------------------------------------ bad-request isolation
def test_bad_requests_rejected_not_fatal():
    task = toy_task()
    bad_part = uniform_partition(task, HW.X, HW.Y)
    bad_part.Px[0, 0] += 7            # sums no longer match M
    good = OptRequest("eval", sweep.EvalPoint(task, HW))
    bads = [
        OptRequest("eval", sweep.EvalPoint(task, HW,
                                           partition=bad_part)),
        OptRequest("nonsense", sweep.EvalPoint(task, HW)),
        OptRequest("solve", sweep.EvalPoint(task, HW),
                   objective="speed"),
        OptRequest("solve", sweep.EvalPoint(task, HW), method="ga",
                   cfg=MIQP_CFG),
        OptRequest("pipeline", sweep.PipelinePoint(SEGS, 0)),
        OptRequest("pipeline",
                   sweep.PipelinePoint([("a", np.nan, 1.0, 1.0)], 2)),
        OptRequest("eval", sweep.EvalPoint(task, HW), backend="cuda"),
        OptRequest("eval", sweep.EvalPoint(task, HW), backend="jax"),
        OptRequest("eval", sweep.EvalPoint(task, HW), backend="auto"),
    ]
    ref = sweep.eval_sweep([good.point], cache=False, device="cpu")[0]
    sweep.clear_cache()
    srv = server()
    bad_futs = [srv.submit(b) for b in bads]
    good_fut = srv.submit(good)
    srv.start()
    # Every malformed request errors with BadRequest on its own future…
    for f in bad_futs:
        with pytest.raises(BadRequest):
            f.result(timeout=WAIT)
    # …while the cohort request and the worker survive.
    _result_equal(ref, good_fut.result(timeout=WAIT))
    _result_equal(ref, srv.submit(good).result(timeout=WAIT))
    st = srv.stats()
    assert st["rejected"] == len(bads)
    assert st["completed"] == 2
    srv.kill()


def test_cosearch_request_rejected_naming_a5_cohort_served():
    """A ``method="cosearch"`` request is served bit for bit its solo
    ``cosearch_sweep``; one on the numpy backend (co-search has no host
    engine) is rejected with a BadRequest on its own future, and its
    cohort is still served."""
    from repro_torch.core.cosearch import CoSearchConfig

    cs_cfg = CoSearchConfig(population=8, generations=3, patience=3,
                            seed_steps=2, seed_starts=2, archive_size=4,
                            device="cpu")
    pt = sweep.EvalPoint(toy_task(2), HW)
    solo = sweep.cosearch_sweep([pt], "edp", cs_cfg, cache=False)[0]
    sweep.clear_cache()
    good = OptRequest("solve", pt, objective="edp", method="cosearch",
                      cfg=cs_cfg)
    bad = OptRequest("solve", pt, objective="edp", method="cosearch",
                     cfg=cs_cfg, backend="numpy")
    ga = OptRequest("solve", pt, objective="edp", cfg=GA_CFG,
                    backend="numpy")
    srv = server()
    fb, fg, fga = srv.submit(bad), srv.submit(good), srv.submit(ga)
    srv.start()
    with pytest.raises(BadRequest, match="needs backend 'torch'"):
        fb.result(timeout=WAIT)
    served = fg.result(timeout=WAIT)
    assert served.objective == solo.objective
    assert (served.edp, served.latency, served.energy, served.diagonal) \
        == (solo.edp, solo.latency, solo.energy, solo.diagonal)
    np.testing.assert_array_equal(served.partition.Px, solo.partition.Px)
    np.testing.assert_array_equal(served.seg_mask, solo.seg_mask)
    np.testing.assert_array_equal(served.history, solo.history)
    for k in solo.front:
        np.testing.assert_array_equal(served.front[k], solo.front[k])
    assert fga.result(timeout=WAIT).objective > 0
    assert srv.stats()["rejected"] == 1
    srv.kill()


# ---------------------------------------------------- retry-with-restore
def test_transient_failure_retries_then_succeeds():
    srv = server(max_retries=2)
    real = srv._calls["eval"]
    fails = {"n": 2}

    def flaky(*a, **kw):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise RuntimeError("simulated transient engine failure")
        return real(*a, **kw)

    srv._calls["eval"] = flaky
    req = OptRequest("eval", sweep.EvalPoint(toy_task(), HW))
    fut = srv.submit(req)
    srv.start()
    rec = fut.result(timeout=WAIT)
    assert rec["latency"] > 0
    st = srv.stats()
    assert st["retries"] == 2
    assert st["failed"] == 0
    srv.kill()


def test_persistent_failure_isolated_by_solo_fallback():
    """A request that poisons its whole coalesced call must not take the
    cohort down: after retries the group re-runs solo and only the
    guilty request errors."""
    poison = sweep.EvalPoint(toy_task(4), HW)
    ok_pts = [sweep.EvalPoint(toy_task(), HW),
              sweep.EvalPoint(toy_task(3, 256), HW)]
    srv = server(max_retries=1)
    real = srv._calls["eval"]

    def booby_trapped(pts, **kw):
        if any(p is poison for p in pts):
            raise ValueError("simulated poisoned point")
        return real(pts, **kw)

    srv._calls["eval"] = booby_trapped
    futs = [srv.submit(OptRequest("eval", pt))
            for pt in (ok_pts[0], poison, ok_pts[1])]
    srv.start()
    assert futs[0].result(timeout=WAIT)["latency"] > 0
    assert futs[2].result(timeout=WAIT)["latency"] > 0
    with pytest.raises(ValueError):
        futs[1].result(timeout=WAIT)
    st = srv.stats()
    assert st["retries"] == 1
    assert st["solo_fallbacks"] == 1
    assert st["failed"] == 1
    assert st["completed"] == 2
    srv.kill()


# -------------------------------------------------------- chaos / store
def test_chaos_kill_restart_resumes_from_store(tmp_path):
    """Kill a server mid-grid (after half the points completed, without
    graceful shutdown); a restarted server on the same store must serve
    the completed half purely from cache — zero recomputation — and
    return bit-identical results for the full grid."""
    store = tmp_path / "sweep-cache.bin"
    pts = [sweep.EvalPoint(toy_task(3, m), HW)
           for m in (128, 256, 384, 512, 640, 768)]
    ref = [sweep.eval_sweep([p], cache=False, device="cpu")[0] for p in pts]
    sweep.clear_cache()

    srv1 = server(store_path=str(store), flush_every=1, autostart=True)
    futs = [srv1.submit(OptRequest("eval", pt)) for pt in pts[:3]]
    for f in futs:
        f.result(timeout=WAIT)
    assert srv1.drain(timeout=WAIT)
    srv1.kill()                        # crash: NO graceful close/save

    sweep.clear_cache()                # "new process"
    srv2 = server(store_path=str(store), flush_every=1, autostart=True)
    assert srv2.store_info["loaded"] == 3
    assert not srv2.store_info["cold_start"]
    futs = [srv2.submit(OptRequest("eval", pt)) for pt in pts]
    recs = [f.result(timeout=WAIT) for f in futs]
    st = srv2.stats()
    assert st["cache_hits"] == 3
    assert st["cache_misses"] == 3
    for a, b in zip(ref, recs):
        _result_equal(a, b)
    srv2.close(timeout=WAIT)
    # graceful close full-saves: a third server loads all six
    sweep.clear_cache()
    srv3 = server(store_path=str(store))
    assert srv3.store_info["loaded"] == 6
    srv3.kill()


def test_store_survives_torn_tail(tmp_path):
    """A store torn mid-record (crash mid-append) still resumes the
    intact prefix on restart."""
    store = tmp_path / "sweep-cache.bin"
    pts = [sweep.EvalPoint(toy_task(3, m), HW) for m in (128, 256, 384)]
    srv = server(store_path=str(store), flush_every=1, autostart=True)
    for f in [srv.submit(OptRequest("eval", pt)) for pt in pts]:
        f.result(timeout=WAIT)
    assert srv.drain(timeout=WAIT)
    srv.kill()
    size = store.stat().st_size
    with open(store, "r+b") as f:
        f.truncate(size - 11)
    sweep.clear_cache()
    srv2 = server(store_path=str(store))
    assert srv2.store_info["torn_tail"]
    assert 0 < srv2.store_info["loaded"] < len(pts)
    srv2.kill()


# -------------------------------------------------------------- stats
def test_stats_shape_and_latency_fields():
    mon = StragglerMonitor()
    srv = server(straggler=mon)
    reqs = _eval_requests("torch")[:2]
    futs = [srv.submit(r) for r in reqs]
    srv.start()
    for f in futs:
        f.result(timeout=WAIT)
    st = srv.stats()
    assert st["submitted"] == 2 and st["inflight"] == 0
    assert st["requests_per_s"] > 0
    assert 0 < st["p50_ms"] <= st["p99_ms"]
    assert st["cache_hit_rate"] == 0.0       # all fresh points
    assert st["store"]["loaded"] == 0        # no store configured
    assert st["batch_ewma_s"] == mon.ewma > 0
    assert st["stragglers"] == len(mon.flagged)
    srv.kill()


def test_straggler_monitor_cold_start():
    """The JAX suite's cold-start contract: a slow first observation is
    flagged retroactively, a later outlier at observe time, and neither
    enters the baseline."""
    m = StragglerMonitor(threshold=2.0, alpha=0.5)
    assert not m.observe(0, 10.0)            # seed, provisional
    assert not m.observe(1, 1.0)             # seed was the outlier
    assert m.flagged == [(0, 10.0)] and m.ewma == 1.0
    assert not m.observe(2, 1.2)
    assert m.observe(3, 5.0)                 # straggler
    assert m.flagged[-1] == (3, 5.0)
    assert m.ewma == pytest.approx(1.1)


def test_cli_demo_runs(monkeypatch, capsys, tmp_path):
    from repro_torch.serve import optserver as mod

    def tiny_traffic(n):
        return [OptRequest("eval", sweep.EvalPoint(toy_task(), HW))
                for _ in range(n)]

    monkeypatch.setattr(mod, "_demo_requests", tiny_traffic)
    mod.main(["--requests", "3", "--device", "cpu",
              "--store", str(tmp_path / "cli-store.bin")])
    out = capsys.readouterr().out
    assert "served 3/3 requests" in out


def test_demo_traffic_is_the_jax_demo():
    from repro.serve import optserver as j_mod
    from repro_torch.serve import optserver as mod

    ours, theirs = mod._demo_requests(10), j_mod._demo_requests(10)
    assert [r.kind for r in ours] == [r.kind for r in theirs]
    for a, b in zip(ours, theirs):
        if a.kind == "pipeline":
            assert a.point.segments == b.point.segments
            assert a.point.batch == b.point.batch
        else:
            assert a.point.task.name == b.point.task.name
            assert (a.point.hw.X, a.point.hw.mcm_type.value) == \
                (b.point.hw.X, b.point.hw.mcm_type.value)
            np.testing.assert_array_equal(a.point.partition.Px,
                                          b.point.partition.Px)


# --------------------------------------------------- multi-tenant firewall
def _mt_request(pt, **kw):
    kw.setdefault("cfg", MT_CFG)
    return OptRequest(kind="solve", method="multitenant", point=pt,
                      objective="edp", **kw)


def test_firewall_accepts_valid_multitenant_request():
    pt = sweep.MultiTenantPoint(
        (toy_task(2, 256), toy_task(2, 512)), two_class_hw())
    req = _mt_request(pt)
    req.validate()
    sig = req.shape_signature()
    assert sig[1] == "multitenant" and sig[2] == (2, 2)


def test_firewall_rejects_corrupted_hetero_fields():
    """Unpickling bypasses __post_init__ — the firewall must re-run the
    field validation on request ingress."""
    pt = sweep.MultiTenantPoint((toy_task(2),), two_class_hw())
    bad_hw = pickle.loads(pickle.dumps(pt.hw))
    object.__setattr__(bad_hw, "class_assignment", (0,) * 5)
    bad_pt = sweep.MultiTenantPoint(pt.tasks, bad_hw)
    with pytest.raises(BadRequest, match="X\\*Y=16"):
        _mt_request(bad_pt).validate()
    object.__setattr__(bad_hw, "class_assignment", (0,) * 16)
    object.__setattr__(bad_hw, "bw_nop", -5.0)
    with pytest.raises(BadRequest, match="finite positive"):
        _mt_request(sweep.MultiTenantPoint(pt.tasks, bad_hw)).validate()


def test_firewall_rejects_malformed_multitenant_points():
    hw = HWConfig()
    with pytest.raises(BadRequest, match="MultiTenantPoint"):
        _mt_request(sweep.EvalPoint(toy_task(2), hw)).validate()
    with pytest.raises(BadRequest, match="non-empty"):
        _mt_request(sweep.MultiTenantPoint((), hw)).validate()
    with pytest.raises(BadRequest, match="Task"):
        _mt_request(
            sweep.MultiTenantPoint(("not-a-task",), hw)).validate()
    with pytest.raises(BadRequest, match="row"):
        _mt_request(sweep.MultiTenantPoint(
            tuple(toy_task(2, name=f"t{i}") for i in range(5)),
            hw)).validate()
    with pytest.raises(BadRequest, match="cfg"):
        _mt_request(sweep.MultiTenantPoint((toy_task(2),), hw),
                    cfg=GAConfig()).validate()


def test_eval_firewall_also_checks_hw():
    hw = pickle.loads(pickle.dumps(two_class_hw()))
    object.__setattr__(hw, "chiplet_classes", ())
    req = OptRequest(kind="eval", point=sweep.EvalPoint(toy_task(2), hw),
                     backend="numpy")
    with pytest.raises(BadRequest, match="invalid hardware config"):
        req.validate()


# ------------------------------------------- the whole slice against JAX
def _jax_traffic():
    """Mixed numpy-backend traffic built in the JAX package: evals in
    both congestion modes, GA solves, pipelines and a multi-tenant
    placement on the hetero grid."""
    from repro.core import ChipletClass as JChipletClass
    from repro.core import HWConfig as JHWConfig

    task = toy_task(gemm=JGemmOp, task=JTask)
    hw = j_make_hw("A", 2, "hbm")
    fast = JChipletClass("fast", freq_hz=2e9, bw_nop=120e9)
    slow = JChipletClass("slow", freq_hz=0.5e9, bw_nop=30e9, mem_scale=0.5)
    het = JHWConfig.hetero([fast, slow], [0] * 8 + [1] * 8)
    reqs = [JOptRequest("eval", j_sweep.EvalPoint(
        task, hw, JEvalOptions(redistribution=r, async_exec=True,
                               congestion=c)), backend="numpy")
        for c in ("regime", "flow") for r in (False, True)]
    reqs += [JOptRequest("solve", j_sweep.EvalPoint(
        toy_task(2, m, gemm=JGemmOp, task=JTask), hw), objective="latency",
        cfg=JGAConfig(generations=4, population=16, patience=4, seed=3),
        backend="numpy") for m in (256, 512)]
    reqs += [JOptRequest("pipeline", j_sweep.PipelinePoint(SEGS, b),
                         cfg=JPipelineConfig(backend="numpy"),
                         backend="numpy") for b in (2, 4)]
    reqs += [JOptRequest("solve", j_sweep.MultiTenantPoint(
        (toy_task(2, 256, "ta", JGemmOp, JTask),
         toy_task(3, 512, "tb", JGemmOp, JTask)), het),
        objective="edp", method="multitenant",
        cfg=JMultiTenantConfig(method="uniform"), backend="numpy")]
    return reqs


def _port_traffic():
    task = toy_task()
    reqs = [OptRequest("eval", sweep.EvalPoint(
        task, HW, EvalOptions(redistribution=r, async_exec=True,
                              congestion=c)), backend="numpy")
        for c in ("regime", "flow") for r in (False, True)]
    reqs += [OptRequest("solve", sweep.EvalPoint(toy_task(2, m), HW),
                        objective="latency", cfg=GA_CFG, backend="numpy")
             for m in (256, 512)]
    reqs += [OptRequest("pipeline", sweep.PipelinePoint(SEGS, b),
                        cfg=PipelineConfig(backend="numpy"),
                        backend="numpy") for b in (2, 4)]
    reqs += [OptRequest("solve", sweep.MultiTenantPoint(
        (toy_task(2, 256, "ta"), toy_task(3, 512, "tb")), two_class_hw()),
        objective="edp", method="multitenant", cfg=MT_CFG,
        backend="numpy")]
    return reqs


def test_served_records_equal_the_jax_servers():
    """The same numpy-backend requests through JAX's OptServer and the
    port's: equal records, request by request, and the same coalescing
    (one batch per call key)."""
    def serve(srv, reqs):
        futs = [srv.submit(r) for r in reqs]
        srv.start()
        out = [f.result(timeout=WAIT) for f in futs]
        st = srv.stats()
        srv.kill()
        return out, st

    want, jst = serve(JOptServer(autostart=False), _jax_traffic())
    got, st = serve(server(), _port_traffic())
    assert (st["batches"], st["completed"]) == \
        (jst["batches"], jst["completed"])
    for a, b in zip(want, got):
        _result_equal(a, b)


# ------------------------------------------------ thread-safe kernel build
def test_kernel_build_is_thread_safe(tmp_path, monkeypatch):
    """Threads that first touch a kernel together (more of them than
    cores, switching often) build it once and get the same loaded
    library (``nvcc`` stubbed: it "compiles" by copying a shared library
    the host has, slowly enough to overlap)."""
    import _ctypes

    from repro_torch.kernels import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "fake.cu").write_text("// a kernel source\n")
    builds = []

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            builds.append(cmd)
            time.sleep(0.2)
            shutil.copy(_ctypes.__file__, cmd[cmd.index("-o") + 1])
            self.returncode = 0

        def communicate(self):
            return ("ptxas info    : Used 1 registers\n", None)

    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "subprocess", types.SimpleNamespace(
        Popen=FakeNvcc, PIPE=subprocess.PIPE, STDOUT=subprocess.STDOUT))
    n = 2 * (os.cpu_count() or 1) + 2
    start = threading.Barrier(n)
    libs, errors = [None] * n, []

    def first_use(i):
        try:
            start.wait(timeout=WAIT)
            libs[i] = _build.load("fake")
        except Exception as e:          # surfaced below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=first_use, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(builds) == 1
    assert libs[0] is not None and all(lib is libs[0] for lib in libs)
    assert _build.library_path("fake").exists()
    assert _build.load("fake") is libs[0]
