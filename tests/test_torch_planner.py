"""The port's analytical engines (``repro_torch.core``) and layout planner
(``repro_torch.sharding.mcm_planner``) against the JAX package's, on the
same HWConfig / Task / Partition built in each package from the same
numbers. Both sides run the same float64 numpy code, so they are held to
rtol 1e-12 (bitwise in practice); the GA, seeded alike, must find the
same partition. Then the JAX planner tests' properties, on the port."""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import evaluator as j_ev
from repro.core import ga as j_ga
from repro.core import hw as j_hw
from repro.core import workload as j_wl
from repro.kernels.calibrate import CalibratedHW as JaxProfile
from repro.sharding import mcm_planner as j_plan
from repro_torch.configs import get_config
from repro_torch.core import evaluator as t_ev
from repro_torch.core import ga as t_ga
from repro_torch.core import hw as t_hw
from repro_torch.core import workload as t_wl
from repro_torch.kernels.calibrate import NVLINK_OVER_HBM, CalibratedHW
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import mcm_planner as t_plan

RTOL = 1e-12
SERVED = ("smollm-360m", "rwkv6-3b", "zamba2-2.7b")
UNSERVED = ("internlm2-20b", "mixtral-8x22b", "deepseek-v2-236b")

# A small chain with every op attribute the evaluator reads: chained
# pairs (redistribution), sync ops, row/col sharing, grouped GEMMs with
# scaled weights, SIMD epilogues, and ragged dims.
OPS = [
    dict(name="a", M=96, K=64, N=80),
    dict(name="b", M=96, K=80, N=48, chained=True, sync=True,
         epilogue_flops_per_elem=5),
    dict(name="c", M=90, K=48, N=70, chained=True, shared_row=True),
    dict(name="d", M=64, K=32, N=40, n_groups=4, weight_bytes_scale=4.0,
         shared_col=True),
    dict(name="e", M=64, K=40, N=56, chained=True, epilogue_flops_per_elem=1),
]
OPTIONS = [
    dict(),
    dict(redistribution=True),
    dict(redistribution=True, async_exec=True),
    dict(async_exec=True, energy_mode="per_chiplet"),
]


def _hw_pair(**kw):
    t = kw.pop("mcm_type", "A")
    return (j_hw.HWConfig(mcm_type=j_hw.MCMType(t), **kw),
            t_hw.HWConfig(mcm_type=t_hw.MCMType(t), **kw))


def _task_pair(ops=OPS, name="t"):
    return (j_wl.Task(name, [j_wl.GemmOp(**o) for o in ops]),
            t_wl.Task(name, [t_wl.GemmOp(**o) for o in ops]))


def _hw_fields(hw):
    out = {}
    for f in dataclasses.fields(hw):
        v = getattr(hw, f.name)
        out[f.name] = getattr(v, "value", v)
    return out


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=0)


def _random_population(task, hw, pop, seed):
    """Sum-exact random partitions around uniform, collectors and
    redistribution choices, as numpy arrays both packages take."""
    rng = np.random.default_rng(seed)
    base = j_wl.uniform_partition(task, hw.X, hw.Y)
    Px = np.repeat(base.Px[None], pop, 0).astype(np.float64)
    Py = np.repeat(base.Py[None], pop, 0).astype(np.float64)
    for arr in (Px, Py):
        for p in range(1, pop):
            for i in range(arr.shape[1]):
                if arr.shape[2] > 1:
                    d, r = rng.choice(arr.shape[2], 2, replace=False)
                    move = min(arr[p, i, d], rng.integers(0, 9))
                    arr[p, i, d] -= move
                    arr[p, i, r] += move
    coll = rng.integers(0, hw.Y, (pop, len(task)))
    redist = (rng.random((pop, len(task))) < 0.6).astype(np.float64)
    return Px, Py, coll, redist


# ------------------------------------------------------------- hardware
@pytest.mark.parametrize("mcm", ["A", "B", "C", "D"])
@pytest.mark.parametrize("diag", [False, True], ids=["mesh", "diag"])
def test_topology_matches_jax(mcm, diag):
    jh, th = _hw_pair(mcm_type=mcm, X=3, Y=4, diagonal_links=diag)
    jt, tt = jh.topology, th.topology
    assert tt.entrances == jt.entrances
    for name in ("entrance_id", "x_local", "y_local", "Xg", "Yg",
                 "entrance_links", "entrance_member", "entrance_pos",
                 "entrance_rows", "entrance_cols", "is_3d",
                 "hops_low", "hops_row_shared", "hops_col_shared",
                 "bw_mem_entrance", "bw_nop_entrance", "group_size"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name),
                                      err_msg=name)


def test_hetero_hw_matches_jax():
    classes = [dict(name="fast", freq_hz=2e9, bw_nop=90e9),
               dict(name="slow", freq_hz=0.5e9, bw_nop=30e9, mem_scale=0.5)]
    assign = [0, 1, 0, 1, 1, 0]
    jh = j_hw.HWConfig.hetero([j_hw.ChipletClass(**c) for c in classes],
                              assign, X=2, Y=3, mcm_type=j_hw.MCMType("B"))
    th = t_hw.HWConfig.hetero([t_hw.ChipletClass(**c) for c in classes],
                              assign, X=2, Y=3, mcm_type=t_hw.MCMType("B"))
    for name in ("bw_nop_xy", "freq_xy", "mem_scale_xy"):
        np.testing.assert_array_equal(getattr(th, name), getattr(jh, name))
    jt, tt = _task_pair()
    Px, Py, coll, rd = _random_population(jt, jh, 6, seed=7)
    for opts in OPTIONS:
        want = j_ev.Evaluator(jt, jh, j_ev.EvalOptions(**opts)
                              ).evaluate_batch(Px, Py, coll, rd)
        got = t_ev.Evaluator(tt, th, t_ev.EvalOptions(**opts)
                             ).evaluate_batch(Px, Py, coll, rd)
        assert set(got) == set(want)
        for key in want:
            _close(got[key], want[key])
    with pytest.raises(ValueError, match="class_assignment"):
        t_hw.HWConfig.hetero([t_hw.ChipletClass()], [0, 0, 0], X=1, Y=2)


# ------------------------------------------------------------ evaluator
@pytest.mark.parametrize("mcm", ["A", "B", "C", "D"])
@pytest.mark.parametrize("diag", [False, True], ids=["mesh", "diag"])
def test_evaluator_matches_jax(mcm, diag):
    """EvalResult fields and the batch outputs (incl. the energy split),
    with and without redistribution and async execution."""
    jh, th = _hw_pair(mcm_type=mcm, X=3, Y=4, diagonal_links=diag, R=16,
                      C=16)
    jt, tt = _task_pair()
    Px, Py, coll, rd = _random_population(jt, jh, 8, seed=1)
    for opts in OPTIONS:
        jev = j_ev.Evaluator(jt, jh, j_ev.EvalOptions(**opts))
        tev = t_ev.Evaluator(tt, th, t_ev.EvalOptions(**opts))
        np.testing.assert_array_equal(tev.chain_valid, jev.chain_valid)
        want = jev.evaluate_batch(Px, Py, coll, rd)
        got = tev.evaluate_batch(Px, Py, coll, rd)
        assert set(got) == set(want)
        for key in want:
            _close(got[key], want[key])
        for p in range(3):
            jp = j_wl.Partition(Px[p].astype(np.int64),
                                Py[p].astype(np.int64), coll[p])
            tp = t_wl.Partition(Px[p].astype(np.int64),
                                Py[p].astype(np.int64), coll[p])
            for mask in (None, rd[p].astype(bool)):
                w, g = jev.evaluate(jp, mask), tev.evaluate(tp, mask)
                for f in ("latency", "energy", "edp", "t_in", "t_comp",
                          "t_out"):
                    _close(getattr(g, f), getattr(w, f))
                np.testing.assert_array_equal(g.redist, w.redist)
                assert g.segments() == w.segments()


@pytest.mark.parametrize("mesh", [(1, 1), (2, 2), (4, 2)])
def test_evaluator_matches_jax_on_gpu_grids(mesh):
    """The planner's hardware (``gpu_hw``: type C, 128x128 tiles, bf16)
    and a served arch's op chain: batch outputs of both evaluators, with
    and without redistribution and async execution."""
    th = t_plan.gpu_hw(mesh)
    jh = j_hw.HWConfig(**{k: (j_hw.MCMType(v) if k == "mcm_type" else v)
                          for k, v in _hw_fields(th).items()})
    tt = t_plan.arch_to_task(get_config("zamba2-2.7b"), 256, 8, layers=6)
    jt = j_plan.arch_to_task(jax_get_config("zamba2-2.7b"), 256, 8,
                             layers=6)
    Px, Py, coll, rd = _random_population(jt, jh, 4, seed=sum(mesh))
    for opts in OPTIONS:
        want = j_ev.Evaluator(jt, jh, j_ev.EvalOptions(**opts)
                              ).evaluate_batch(Px, Py, coll, rd)
        got = t_ev.Evaluator(tt, th, t_ev.EvalOptions(**opts)
                             ).evaluate_batch(Px, Py, coll, rd)
        assert set(got) == set(want)
        for key in want:
            _close(got[key], want[key])
    with pytest.raises(ValueError, match="energy_mode"):
        t_ev.EvalOptions(energy_mode="total")


def test_workload_domain_matches_jax():
    jt, tt = _task_pair()
    for X, Y, R, C in ((2, 3, 16, 16), (4, 4, 8, 32)):
        for a, b in zip(j_wl.partition_domain(jt, X, Y, R, C),
                        t_wl.partition_domain(tt, X, Y, R, C)):
            np.testing.assert_array_equal(b, a)
        rng = np.random.default_rng(X)
        Px = rng.integers(0, 60, (len(OPS), X))
        Py = rng.integers(0, 60, (len(OPS), Y))
        coll = rng.integers(-1, Y + 1, len(OPS))
        want = j_wl.clamp_partition_to_domain(
            j_wl.Partition(Px.copy(), Py.copy(), coll.copy()), jt, X, Y, R, C)
        got = t_wl.clamp_partition_to_domain(
            t_wl.Partition(Px.copy(), Py.copy(), coll.copy()), tt, X, Y, R, C)
        for f in ("Px", "Py", "collectors"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        got.validate(tt)


# ------------------------------------------------------------------- GA
@pytest.mark.parametrize("objective", ["latency", "edp"])
@pytest.mark.parametrize("freeze", [False, True], ids=["free", "frozen"])
def test_ga_matches_jax(objective, freeze):
    """Same seed, same budget: the same objective, partition, mask and
    trajectory as the JAX package's reference (python) engine."""
    jh, th = _hw_pair(mcm_type="B", X=2, Y=3, R=16, C=16)
    jt, tt = _task_pair()
    opts = dict(redistribution=True, async_exec=True)
    cfg = dict(population=16, generations=6, seed=3, freeze_redist=freeze)
    want = j_ga.run_ga(jt, jh, objective, j_ev.EvalOptions(**opts),
                       j_ga.GAConfig(engine="python", **cfg))
    got = t_ga.run_ga(tt, th, objective, t_ev.EvalOptions(**opts),
                      t_ga.GAConfig(**cfg))
    _close(got.objective, want.objective)
    _close(got.history, want.history)
    assert got.evaluations == want.evaluations
    for f in ("Px", "Py", "collectors"):
        np.testing.assert_array_equal(getattr(got.partition, f),
                                      getattr(want.partition, f))
    np.testing.assert_array_equal(got.redist_mask, want.redist_mask)


# ------------------------------------------------------------- planner
def _port_cfg(name):
    """The port's ModelConfig of an arch: its own config where the port
    serves the arch, else built from the JAX config's fields."""
    if name in SERVED:
        return get_config(name)
    jc = jax_get_config(name)
    return ModelConfig(**{f.name: getattr(jc, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def _ops(task):
    return [dataclasses.astuple(op) for op in task.ops]


@pytest.mark.parametrize("arch", SERVED + UNSERVED)
def test_arch_to_task_matches_jax(arch):
    for seq, batch, layers in ((512, 8, 2), (128, 4, None)):
        want = j_plan.arch_to_task(jax_get_config(arch), seq, batch,
                                   layers=layers)
        got = t_plan.arch_to_task(_port_cfg(arch), seq, batch,
                                  layers=layers)
        assert got.name == want.name
        assert _ops(got) == _ops(want)


def _profiles():
    kw = dict(backend="cuda", flops_per_s=3.1e13, bytes_per_s=2.2e12,
              byte_overhead=1.0, nop_frac=NVLINK_OVER_HBM)
    return JaxProfile(**kw), CalibratedHW(**kw)


@pytest.mark.parametrize("mesh", [(1, 1), (2, 2), (4, 2)])
def test_gpu_hw_matches_tpu_hw_under_a_profile(mesh):
    jp, tp = _profiles()
    assert _hw_fields(t_plan.gpu_hw(mesh, profile=tp)) == \
        _hw_fields(j_plan.tpu_hw(mesh, profile=jp))


def test_gpu_hw_datasheet_constants():
    hw = t_plan.gpu_hw((2, 2))
    assert hw.mcm_type.value == "C" and (hw.R, hw.C) == (128, 128)
    assert hw.bytes_per_elem == 2
    assert hw.R * hw.C * 2 * hw.freq_hz == pytest.approx(989e12)
    assert hw.bw_mem == pytest.approx(3.35e12 * 4)
    assert hw.bw_nop == 450e9


@pytest.mark.parametrize("arch", SERVED)
@pytest.mark.parametrize("mesh", [(1, 1), (2, 2)])
def test_plan_matches_jax(arch, mesh):
    """planner_validate's slice: seq 512, batch 8, 2 layers rounded up to
    the arch's period."""
    jp, tp = _profiles()
    cfg = _port_cfg(arch)
    per = cfg.hybrid_attn_period or cfg.local_global_period or 1
    L = per * max(1, -(-2 // per))
    want = j_plan.plan(jax_get_config(arch), mesh, 512, 8, layers=L,
                       ga_budget=2, profile=jp)
    got = t_plan.plan(cfg, mesh, 512, 8, layers=L, ga_budget=2, profile=tp)
    assert got.arch == want.arch
    for f in ("baseline_latency", "optimized_latency",
              "nonuniform_headroom", "modeled_speedup"):
        _close(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(got.redist_mask, want.redist_mask)
    assert got.knobs.keys() == want.knobs.keys()
    for k in ("shard_residual", "accum_steps"):
        assert got.knobs[k] == want.knobs[k]
    np.testing.assert_array_equal(got.knobs["redist_mask"],
                                  want.knobs["redist_mask"])


# ------------------------------------------------- the planner's properties
@pytest.mark.parametrize("arch", SERVED + UNSERVED[:2])
def test_partition_conserves_flops_and_bytes(arch):
    cfg = _port_cfg(arch)
    for (X, Y), layers in (((1, 1), 1), ((2, 2), 2), ((4, 2), 3)):
        task = t_plan.arch_to_task(cfg, 256, 8, layers=layers)
        part = t_wl.uniform_partition(task, X, Y)
        total = 0
        for i, op in enumerate(task.ops):
            assert int(part.Px[i].sum()) == op.M
            assert int(part.Py[i].sum()) == op.N
            total += 2 * int(part.Px[i].sum()) * op.K * int(part.Py[i].sum())
        assert total == task.total_flops


def test_task_flops_affine_in_layers():
    for arch in SERVED:
        cfg = get_config(arch)
        f1, f2, f4 = (t_plan.arch_to_task(cfg, 128, 4, layers=n).total_flops
                      for n in (1, 2, 4))
        assert f4 - f2 == 2 * (f2 - f1) and f2 > f1
        names = [op.name for op in t_plan.arch_to_task(cfg, 128, 4,
                                                       layers=1).ops]
        assert names[-1] == "lm_head"


@pytest.mark.parametrize("batch", [1, 3, 8])
def test_plan_knobs_always_executable(batch):
    cfg = get_config("smollm-360m")
    pr = t_plan.plan(cfg, (2, 2), 128, batch, layers=1, ga_budget=2)
    assert batch % pr.knobs["accum_steps"] == 0
    task = t_plan.arch_to_task(cfg, 128, max(batch // 4, 1) * 4, layers=1)
    ev = t_ev.Evaluator(task, t_plan.gpu_hw((2, 2)),
                        t_ev.EvalOptions(redistribution=True))
    assert np.all(pr.redist_mask <= ev.chain_valid)
    assert pr.nonuniform_headroom >= 1.0
    assert pr.knobs["shard_residual"] == bool(pr.redist_mask.any())
    assert np.isfinite(pr.baseline_latency) and pr.optimized_latency > 0


def test_gpu_hw_profile_rescales_constants():
    prof = CalibratedHW(backend="cuda", flops_per_s=1e11, bytes_per_s=1e10,
                        byte_overhead=2.0)
    base = t_plan.gpu_hw((4, 2))
    hw = t_plan.gpu_hw((4, 2), profile=prof)
    assert (hw.X, hw.Y, hw.R, hw.C) == (base.X, base.Y, base.R, base.C)
    assert hw.freq_hz == pytest.approx(1e11 / (2 * 128 * 128))
    assert hw.bw_mem == pytest.approx(5e9 * 8)
    assert hw.bw_nop == pytest.approx(5e9 * prof.nop_frac)
    pr = t_plan.plan(get_config("smollm-360m"), (2, 2), 128, 4, layers=1,
                     ga_budget=2, profile=prof)
    assert pr.optimized_latency > 0
