"""The port's counterparts of the JAX package's last two examples, on the
CPU: ``launch.plan_mesh`` (``examples/mcm_plan_tpu.py``: the planner
over the zoo on a 16x16 grid) against ``repro.sharding.mcm_planner.plan``
at the example's settings, and ``launch.optserve_client``
(``examples/optserve_client.py``: mixed traffic through ``OptServer``, a
warm restart, the asyncio path) cold against warm and against JAX's
server on the example's own requests."""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.calibrate import CalibratedHW as JaxProfile
from repro.serve import OptServer as JOptServer
from repro.sharding import mcm_planner as j_plan
from repro_torch.kernels.calibrate import NVLINK_OVER_HBM, CalibratedHW
from repro_torch.launch import optserve_client, plan_mesh

EXAMPLES = os.path.join(os.path.dirname(__file__), os.pardir, "examples")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_plan_mesh_rows_match_jax():
    """One dense arch and one MoE arch at the example's settings ((16,
    16), seq 4096, batch 256, 2 layers, GA budget 10) under the same
    calibrated profile, mapped as ``test_plan_matches_jax`` maps it:
    every field at rtol 1e-12, and each printed row is the example's
    format of JAX's result."""
    kw = dict(backend="cuda", flops_per_s=3.1e13, bytes_per_s=2.2e12,
              byte_overhead=1.0, nop_frac=NVLINK_OVER_HBM)
    jp, tp = JaxProfile(**kw), CalibratedHW(**kw)
    archs = ("smollm-360m", "mixtral-8x22b")
    got = plan_mesh.plan_zoo(archs, profile=tp)
    assert plan_mesh.HEADER == _example_header()
    for arch in archs:
        want = j_plan.plan(jax_get_config(arch), (16, 16), 4096, 256,
                           layers=2, ga_budget=10, profile=jp)
        r = got[arch]
        for f in ("baseline_latency", "optimized_latency",
                  "nonuniform_headroom", "modeled_speedup"):
            np.testing.assert_allclose(getattr(r, f), getattr(want, f),
                                       rtol=1e-12, err_msg=f)
        np.testing.assert_array_equal(r.redist_mask, want.redist_mask)
        assert plan_mesh.row(arch, r) == plan_mesh.row(arch, want)


def _example_header() -> str:
    """The header line ``examples/mcm_plan_tpu.py`` prints."""
    import contextlib
    import io

    mod = _example("mcm_plan_tpu")
    out = io.StringIO()
    # print the header only: the first plan call stops the run
    with contextlib.redirect_stdout(out), pytest.raises(StopIteration):
        mod.plan = lambda *a, **k: next(iter(()))
        mod.main()
    return out.getvalue().splitlines()[0]


def test_plan_mesh_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan_mesh.main([])


def test_optserve_client_cold_warm_and_jax(tmp_path):
    """The walkthrough on the CPU: the warm pass (a restarted server, the
    same store, ``submit_async``) reads every request from the store and
    returns the cold pass's results; the evaluations equal JAX's
    ``OptServer`` on the JAX example's own requests (numpy backend, which
    runs on this host) at rtol 1e-9."""
    log = []
    out = optserve_client.run(str(tmp_path / "cache.bin"), "cpu",
                              log=log.append)
    reqs = optserve_client.build_requests()
    assert out["loaded"] == len(reqs)
    assert out["cold_stats"]["cache_hit_rate"] == 0.0
    assert out["warm_stats"]["cache_hit_rate"] == 1.0
    for r, a, b in zip(reqs, out["cold"], out["warm"]):
        if r.kind == "eval":
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        elif r.kind == "solve":
            assert (a.objective, a.evaluations) == (b.objective,
                                                    b.evaluations)
        else:
            assert (a.sequential, a.pipelined) == (b.sequential,
                                                   b.pipelined)
    assert any(ln.startswith("warm:  6 requests, cache hit-rate 100%")
               for ln in log)

    jreqs = [dataclasses.replace(r, backend="numpy")
             for r in _example("optserve_client").build_requests()
             if r.kind == "eval"]
    srv = JOptServer()
    want = [f.result(timeout=120) for f in map(srv.submit, jreqs)]
    srv.kill()
    got = [res for r, res in zip(reqs, out["cold"]) if r.kind == "eval"]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if np.issubdtype(np.asarray(w[k]).dtype, np.number):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-9,
                                           err_msg=k)
            else:                       # the two packages' own types
                assert repr(g[k]) == repr(w[k]), k


def test_optserve_client_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        optserve_client.main([])
