"""The port's dry run (``repro_torch.launch.dryrun``), roofline and plan
knobs against the JAX package's: per-device matmul FLOPs of a reduced
smollm prefill on a fake (1, 1) mesh against the ``dot_general`` FLOPs of
JAX's jaxpr of the same step; the collective bytes of a hand-built
tensor-parallel matmul pair; ``execute_plan`` with the assertions of
JAX's ``test_plan_roundtrips_into_dryrun_artifact``; ``calibrate_cell``
against the full-depth trace; argument bytes against the specs;
``to_dryrun_knobs``, ``analytic_hbm_bytes``, ``model_flops_for`` and
``analyze_record`` against JAX's. The fake world runs in a subprocess of
its own."""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import runnable_cells as jax_cells
from repro.models import forward as jax_forward
from repro.models import init_caches as jax_init_caches
from repro.models import init_model as jax_init_model
from repro.roofline import analysis as jroof
from repro.sharding.mcm_planner import plan as jax_plan
from repro_torch.configs import get_config, runnable_cells
from repro_torch.roofline import analysis as troof
from repro_torch.sharding.mcm_planner import plan

from _torch_dist import run

_WORLD = r"""
import json
import logging

import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.configs import SHAPE_DEFS, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.specs import cache_specs, input_specs
from repro_torch.models.transformer import Transformer
from repro_torch.sharding.logical import local_shape
from repro_torch.sharding.mcm_planner import plan
from repro_torch.sharding.partition_specs import param_specs

logging.disable(logging.WARNING)
out = {}
cfg = get_config("smollm-360m", reduced=True)
SHAPE_DEFS["__t"] = dict(seq_len=64, global_batch=8, kind="prefill")

dryrun.ensure_fake_world(1)
mesh = make_debug_mesh(1)
out["flops11"] = dryrun.run_cell("smollm-360m", "__t", "t", mesh, cfg=cfg)

dryrun.ensure_fake_world(4)
mesh = make_debug_mesh(4)
# a tensor-parallel pair: x (B, S, D) over data, W1 (D, F) FSDP over
# data and split over model by columns, W2 (F, D) by rows
B, S, D, F = 8, 16, 32, 64
with dryrun.fake_mode():
    x = distribute_tensor(torch.empty(B, S, D), mesh, [Shard(0), Replicate()])
    w1 = distribute_tensor(torch.empty(D, F), mesh, [Shard(0), Shard(1)])
    w2 = distribute_tensor(torch.empty(F, D), mesh, [Replicate(), Shard(0)])

    def pair():
        h = x @ w1.redistribute(mesh, [Replicate(), Shard(1)])
        y = h @ w2
        return y.redistribute(mesh, [Shard(0), Replicate()])
    y, c = dryrun.count(pair)
out["pair"] = {"coll": c.coll, "flops": c.flops,
               "placements": [[type(p).__name__, getattr(p, "dim", None)]
                              for p in y.placements]}

pr = plan(cfg, (2, 2), 64, 8, layers=cfg.n_layers, ga_budget=2)
SHAPE_DEFS["__test_plan_roundtrip"] = dict(seq_len=64, global_batch=8,
                                           kind="prefill")
rec = dryrun.execute_plan(pr, "smollm-360m", "__test_plan_roundtrip", mesh,
                          mesh_name="test", cfg=cfg, serve_fsdp=("data",))
out["plan"] = {"rec": rec, "knobs": pr.knobs["shard_residual"],
               "accum": pr.knobs["accum_steps"],
               "mask": [int(b) for b in pr.redist_mask]}

deep = cfg.replace(n_layers=4)
out["full"] = dryrun.run_cell("smollm-360m", "__t", "t", mesh, cfg=deep)
out["calib"] = dryrun.calibrate_cell("smollm-360m", "__t", mesh, cfg=deep)

params = dict(Transformer(deep, "meta", train=True).named_parameters())
specs = param_specs(deep, params, mesh)
want = sum(torch.Size(local_shape(p.shape, specs[n], mesh)).numel()
           * p.element_size() for n, p in params.items())
with dryrun.fake_mode():
    batch = input_specs(deep, "__t", mesh)
    caches, _ = cache_specs(deep, "__t", mesh)
    want += sum(t.to_local().numel() * t.element_size()
                for t in list(batch.values()) + [
                    v for d in caches.values() for v in d.values()])
out["args"] = {"want": want,
               "got": out["full"]["memory"]["argument_size_in_bytes"]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def world():
    stdout = run([sys.executable, "-c", _WORLD], timeout=300)
    return json.loads(stdout.strip().splitlines()[-1])


def _dot_flops(jaxpr) -> int:
    """2·M·N·K of every ``dot_general`` of a jaxpr, inner jaxprs too (a
    scan's body times its length)."""
    tot = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            a = eqn.invars[0].aval.shape
            k = int(np.prod([a[i] for i in lc]))
            tot += 2 * int(np.prod(eqn.outvars[0].aval.shape)) * k
        mult = eqn.params.get("length", 1) if eqn.primitive.name == "scan" \
            else 1
        for p in eqn.params.values():
            for q in (p if isinstance(p, (list, tuple)) else [p]):
                if hasattr(q, "jaxpr") and hasattr(q, "consts"):
                    tot += _dot_flops(q.jaxpr) * mult
                elif type(q).__name__ == "Jaxpr":
                    tot += _dot_flops(q) * mult
    return tot


def test_prefill_matmul_flops_match_jax_jaxpr(world):
    """Reduced smollm, prefill of B 8 × S 64 into its caches, on a fake
    (1, 1) mesh: the port's counted mm + bmm FLOPs (the plain attention's
    included) equal the dot_general FLOPs of JAX's jaxpr of the same step
    (no op differs)."""
    jcfg = jax_get_config("smollm-360m", reduced=True)
    params = jax.eval_shape(lambda k: jax_init_model(jcfg, k),
                            jax.random.PRNGKey(0))
    caches = jax.eval_shape(lambda: jax_init_caches(jcfg, 8, 64,
                                                    dtype=jnp.bfloat16))
    batch = {"tokens": jax.ShapeDtypeStruct((8, 64), jnp.int32)}

    def prefill(p, b, c):
        return jax_forward(p, jcfg, b, mode="prefill", caches=c)[:2]
    want = _dot_flops(jax.make_jaxpr(prefill)(params, batch, caches).jaxpr)
    rec = world["flops11"]
    got = sum(v for k, v in rec["flops_by_op"].items()
              if k in ("mm", "addmm", "bmm", "baddbmm"))
    np.testing.assert_allclose(got, want, rtol=1e-9)
    assert rec["flops_per_device"] == got
    assert rec["kernel_flops_per_device"]["flash_attention"] > 0
    assert rec["collective_bytes_per_device"] == {}
    assert rec["n_devices"] == 1 and rec["compile_s"] == 0.0


def test_tensor_parallel_pair_collective_bytes(world):
    """x (8, 16, 32) over data (2) · W1 (32, 64) gathered from FSDP and
    split by columns over model (2) · W2 (64, 32) split by rows: one
    all-gather of W1's column shard (32 × 32 f32 out) and one all-reduce
    of the partial output (4 × 16 × 32 f32), per device."""
    p = world["pair"]
    assert p["coll"] == {"all-gather": 32 * 32 * 4.0,
                         "all-reduce": 4 * 16 * 32 * 4.0}
    assert p["flops"] == 2 * 4 * 16 * 32 * 32 * 2
    assert p["placements"] == [["Shard", 0], ["Replicate", None]]


def test_plan_roundtrips_into_dryrun_record(world):
    """JAX's ``test_plan_roundtrips_into_dryrun_artifact`` on a fake
    (2, 2) mesh."""
    p = world["plan"]
    rec = p["rec"]
    assert rec["flops_per_device"] > 0
    assert rec["plan"]["knobs"]["shard_residual"] == p["knobs"]
    assert rec["plan"]["knobs"]["accum"] == p["accum"]
    assert rec["plan"]["redist_mask"] == p["mask"]
    assert rec["plan"]["nonuniform_headroom"] >= 1.0
    for key in ("arch", "shape", "mesh", "kind", "n_devices", "lower_s",
                "compile_s", "memory", "flops_per_device",
                "bytes_per_device", "collective_bytes_per_device"):
        assert key in rec, key
    assert set(rec["memory"]) == {"argument_size_in_bytes",
                                  "output_size_in_bytes",
                                  "temp_size_in_bytes"}
    assert set(rec["collective_bytes_per_device"]) <= {
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute"}
    json.dumps(rec)


def test_to_dryrun_knobs_match_jax():
    cfg, jcfg = (get_config("smollm-360m", reduced=True),
                 jax_get_config("smollm-360m", reduced=True))
    for batch in (8, 6, 5):
        got = plan(cfg, (2, 2), 64, batch, layers=1, ga_budget=2)
        want = jax_plan(jcfg, (2, 2), 64, batch, layers=1, ga_budget=2)
        assert got.to_dryrun_knobs() == want.to_dryrun_knobs()


def test_calibrate_cell_equals_full_depth_trace(world):
    """JAX's per-unit extrapolation from 1 and 2 layers to 4 equals the
    4-layer trace: the port counts every layer's ops."""
    full, cal = world["full"], world["calib"]
    assert cal["units"] == [1, 2, 4]
    np.testing.assert_allclose(cal["flops_per_device"],
                               full["flops_per_device"], rtol=1e-12)
    np.testing.assert_allclose(cal["bytes_per_device"],
                               full["bytes_per_device"], rtol=1e-12)
    assert set(cal["collective_bytes_per_device"]) == set(
        full["collective_bytes_per_device"])
    for k, v in full["collective_bytes_per_device"].items():
        np.testing.assert_allclose(cal["collective_bytes_per_device"][k], v,
                                   rtol=1e-12)


def test_argument_bytes_equal_the_specs(world):
    """A traced record's argument bytes are the local shards' bytes the
    specs give: parameters, batch and caches."""
    a = world["args"]
    assert a["got"] == a["want"] > 0


def test_runnable_cells_match_jax():
    assert runnable_cells() == jax_cells()


@pytest.mark.parametrize("arch,shape", jax_cells())
def test_analytic_hbm_bytes_and_model_flops_match_jax(arch, shape):
    np.testing.assert_allclose(troof.analytic_hbm_bytes(arch, shape),
                               jroof.analytic_hbm_bytes(arch, shape),
                               rtol=1e-12)
    np.testing.assert_allclose(troof.model_flops_for(arch, shape),
                               jroof.model_flops_for(arch, shape),
                               rtol=1e-12)


def test_analyze_record_matches_jax_with_its_constants():
    rec = {"arch": "gemma2-2b", "shape": "train_4k",
           "mesh": "single_pod_16x16", "kind": "train", "n_devices": 256,
           "flops_per_device": 3.1e14, "bytes_per_device": 2.2e13,
           "collective_bytes_per_device": {"all-gather": 4.0e10,
                                           "reduce-scatter": 1.5e10}}
    for r in (rec, dict(rec, calibrated={
            "flops_per_device": 2.9e14, "bytes_per_device": 2.0e13,
            "collective_bytes_per_device": {"all-reduce": 3.0e10}})):
        want = jroof.analyze_record(r)
        got = troof.analyze_record(r, peak_flops=jroof.PEAK_FLOPS,
                                   hbm_bw=jroof.HBM_BW,
                                   link_bw=jroof.LINK_BW)
        for f in ("compute_s", "memory_s", "collective_s", "model_flops",
                  "hlo_flops_global", "per_device_hbm_bytes", "hlo_bytes_s",
                  "bound_time", "useful_ratio", "roofline_fraction"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=1e-12, err_msg=f)
        assert got.dominant == want.dominant
        assert got.collective_breakdown == want.collective_breakdown
    # the port's defaults are the H100's
    h = troof.analyze_record(rec)
    assert h.compute_s == rec["flops_per_device"] / 989e12
    assert troof.format_table([h]).splitlines()[2].startswith("gemma2-2b")
