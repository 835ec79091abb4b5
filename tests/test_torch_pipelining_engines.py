"""The port's batched pipelining engine (``repro_torch.core.pipelining_torch``
on the plain batched SGS, ``repro_torch.kernels.sgs.ref``) and its sweep
(``pipeline_sweep``) against the JAX package's engines (DESIGN.md §13).
The JAX package runs on its numpy engines (its JAX backend needs
``jax.experimental.enable_x64``, which jax 0.9 lacks: ROADMAP.md).

Contract: bit-identical makespans and starts — the plain batched SGS
performs the serial heap SGS's exact pop sequence and arithmetic — against
JAX's ``_frontier_schedule_host``, ``vectorized_schedule(backend="numpy")``
and ``list_schedule``; and ``pipeline_sweep`` records equal to JAX's
``pipeline_sweep(backend="numpy")``. The CUDA kernel is held to the plain
version on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``)."""
import numpy as np
import pytest
import torch

from repro.core import pipelining as j_pipe
from repro.core import sweep as j_sweep
from repro_torch.core import pipelining as t_pipe
from repro_torch.core import pipelining_torch
from repro_torch.core import sweep as t_sweep
from repro_torch.kernels.sgs import kernel as sgs_kernel
from repro_torch.kernels.sgs import ops as sgs_ops
from repro_torch.kernels.sgs.ref import sgs_batch_ref


def _random_segments(rng, n=None, p_zero=0.3, ties=False):
    """The JAX suite's segments; ``ties`` rounds durations to integers so
    that priorities tie often."""
    n = int(rng.integers(1, 6)) if n is None else n
    segs = []
    for i in range(n):
        durs = np.where(rng.random(3) < p_zero, 0.0, rng.uniform(0.0, 5.0, 3))
        if ties:
            durs = np.round(durs)
        segs.append((f"op{i}", float(durs[0]), float(durs[1]),
                     float(durs[2])))
    return segs


def _serial_starts_array(segments, batch):
    jobs = j_pipe.build_jobs(segments, batch)
    ms, starts = j_pipe.list_schedule(jobs)
    L = 3 * len(segments)
    arr = np.array([[starts[s * L + p] for p in range(L)]
                    for s in range(batch)]).reshape(batch, L)
    return ms, arr


def _assert_exact(got, want):
    ms, starts = got
    assert ms == want[0]
    assert starts.shape == want[1].shape
    assert np.array_equal(starts, want[1])


@pytest.fixture(autouse=True)
def _fresh_cache():
    t_sweep.clear_cache()
    j_sweep.clear_cache()
    yield
    t_sweep.clear_cache()
    j_sweep.clear_cache()


# ------------------------------------------------------ engine parity
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_plain_batched_sgs_equals_every_jax_engine(ties):
    """Random chains (and integer durations, where priorities tie) at
    batch 1..6: the plain batched SGS, solo and in a grid, equals JAX's
    host frontier, vectorized_schedule and the serial heap SGS."""
    rng = np.random.default_rng(7 if ties else 0)
    for _ in range(25):
        segs = _random_segments(rng, ties=ties)
        batch = int(rng.integers(1, 7))
        dur = j_pipe._segment_durations(segs)
        want = j_pipe._frontier_schedule_host(
            dur, j_pipe.chain_priorities(dur), batch)
        _assert_exact(j_pipe.vectorized_schedule(segs, batch,
                                                 backend="numpy"), want)
        _assert_exact(_serial_starts_array(segs, batch), want)
        _assert_exact(t_pipe.vectorized_schedule(segs, batch,
                                                 backend="torch",
                                                 device="cpu"), want)
        _assert_exact(t_pipe.vectorized_schedule(segs, batch), want)
        _assert_exact(pipelining_torch.sgs_instance(dur, batch, "cpu"),
                      want)


def test_grid_of_points_equals_solo_schedules():
    """One batched call over a grid of same-shape points equals each
    point's solo schedule, bit for bit."""
    rng = np.random.default_rng(3)
    grid = np.stack([np.array([s[1:] for s in _random_segments(rng, n=4)])
                     for _ in range(5)])
    out = pipelining_torch.schedule_batch(grid, 3, device="cpu")
    assert out["makespan"].shape == (5,) and out["starts"].shape == (5, 3, 12)
    for g in range(5):
        segs = [(f"op{i}", *grid[g, i]) for i in range(4)]
        want = j_pipe.vectorized_schedule(segs, 3, backend="numpy")
        _assert_exact((out["makespan"][g], out["starts"][g]), want)


def test_degenerate_sizes():
    """L = 0 or batch 0 give zeros (as the JAX engine); batch 1 and a
    chain of zero durations schedule like the serial engine."""
    empty = pipelining_torch.schedule_batch(np.zeros((2, 0, 3)), 4,
                                            device="cpu")
    assert np.array_equal(empty["makespan"], np.zeros(2))
    assert empty["starts"].shape == (2, 4, 0)
    none = pipelining_torch.schedule_batch(np.ones((3, 2, 3)), 0,
                                           device="cpu")
    assert np.array_equal(none["makespan"], np.zeros(3))
    assert none["starts"].shape == (3, 0, 6)
    assert t_pipe.pipeline_batch([("a", 0.0, 0.0, 0.0)], 4).pipelined == 0.0
    for segs in ([("a", 1.0, 2.0, 3.0)], [("a", 0.0, 0.0, 0.0)],
                 [("a", 1.0, 0.0, 2.0), ("b", 0.0, 3.0, 0.0)]):
        for b in (1, 2, 5):
            _assert_exact(t_pipe.vectorized_schedule(segs, b,
                                                     backend="torch",
                                                     device="cpu"),
                          j_pipe.vectorized_schedule(segs, b,
                                                     backend="numpy"))


def test_ops_route_cpu_tensors_to_the_plain_version():
    """CPU tensors go to the plain version (no build, no launch); the
    kernel's wrapper refuses them before any build."""
    dur = torch.tensor([[1.0, 2.0, 0.5, 0.0, 1.5, 1.0]], dtype=torch.float64)
    prio = torch.flip(torch.cumsum(torch.flip(dur, [1]), 1), [1])
    before = sgs_kernel.sgs_batch.launches
    got = sgs_ops.sgs_batch(dur, prio, 3)
    want = sgs_batch_ref(dur, prio, 3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert sgs_kernel.sgs_batch.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        sgs_kernel.sgs_batch(dur, prio, 3)


def test_pipelining_torch_needs_a_device_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None means it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipelining_torch.schedule_batch(np.ones((1, 2, 3)), 2)


def test_pipeline_batch_backends():
    """A solo pipeline_batch resolves "auto" to numpy; an explicit torch
    backend (on the CPU) gives the same makespan; an unknown one raises."""
    rng = np.random.default_rng(1)
    segs = _random_segments(rng, n=3)
    r_auto = t_pipe.pipeline_batch(segs, 4)
    r_torch = t_pipe.pipeline_batch(segs, 4, config=t_pipe.PipelineConfig(
        backend="torch", device="cpu"))
    r_py = t_pipe.pipeline_batch(segs, 4,
                                 config=t_pipe.PipelineConfig(engine="python"))
    want = j_pipe.pipeline_batch(segs, 4)
    assert r_auto.pipelined == r_torch.pipelined == r_py.pipelined \
        == want.pipelined
    assert r_auto.engine == "vectorized" and r_py.engine == "python"
    with pytest.raises(ValueError, match="backend"):
        t_pipe.vectorized_schedule(segs, 4, backend="jax")


# ------------------------------------------- batched sweep invariants
def _sweep_points(pkg, rng_seed=2):
    sweep = t_sweep if pkg == "torch" else j_sweep
    rng = np.random.default_rng(rng_seed)
    return [sweep.PipelinePoint(_random_segments(rng, n=n), b)
            for n in (1, 3, 4) for b in (2, 5)]


def test_pipeline_sweep_solo_eq_batched_and_equals_jax():
    """One sweep over points of different (n_ops, batch) shapes returns,
    per point, exactly what a solo call returns and what JAX's numpy
    sweep returns."""
    pts = _sweep_points("torch")
    batched = t_sweep.pipeline_sweep(pts, device="cpu", cache=False)
    want = j_sweep.pipeline_sweep(_sweep_points("jax"), backend="numpy",
                                  cache=False)
    for pt, rec, ref in zip(pts, batched, want):
        solo = t_sweep.pipeline_sweep([pt], device="cpu", cache=False)[0]
        ms, _ = _serial_starts_array(pt.segments, pt.batch)
        assert rec.pipelined == solo.pipelined == ref.pipelined == ms
        assert rec.sequential == ref.sequential
        assert rec.batch == ref.batch and rec.engine == ref.engine


def test_pipeline_sweep_cache_and_config_isolation():
    rng = np.random.default_rng(3)
    pts = [t_sweep.PipelinePoint(_random_segments(rng, n=2), b)
           for b in (2, 3)]
    a = t_sweep.pipeline_sweep(pts, device="cpu")
    assert t_sweep.cache_stats() == {"hits": 0, "misses": len(pts)}
    b = t_sweep.pipeline_sweep(pts, device="cpu")
    assert t_sweep.cache_stats()["hits"] == len(pts)
    assert all(x.pipelined == y.pipelined for x, y in zip(a, b))
    # "auto" in the config resolves to torch inside the sweep: the same
    # record; devices is not part of the key
    t_sweep.pipeline_sweep(pts, t_pipe.PipelineConfig(devices="single"),
                           device="cpu")
    assert t_sweep.cache_stats()["hits"] == 2 * len(pts)
    # a different engine config is a different record family
    c = t_sweep.pipeline_sweep(pts, t_pipe.PipelineConfig(engine="python"))
    assert t_sweep.cache_stats()["misses"] == 2 * len(pts)
    assert all(x.pipelined == y.pipelined for x, y in zip(a, c))
    # numpy backend: same results, its own cache records
    d = t_sweep.pipeline_sweep(pts, backend="numpy")
    assert t_sweep.cache_stats()["misses"] == 3 * len(pts)
    assert all(x.pipelined == y.pipelined for x, y in zip(a, d))
    keys = {k[1] for k in t_sweep.export_cache()}
    assert keys == {"numpy", ("torch", "cpu")}
    with pytest.raises(ValueError, match="backend"):
        t_sweep.pipeline_sweep(pts, backend="jax")
    # devices="sharded" (one-entry mesh here) is bitwise the records
    e = t_sweep.pipeline_sweep(pts, device="cpu", devices="sharded",
                               cache=False)
    assert [x.pipelined for x in e] == [x.pipelined for x in a]
    with pytest.raises(ValueError, match="devices"):
        t_sweep.pipeline_sweep(pts, device="cpu", devices="tpu")


def test_pipeline_sweep_honors_config_backend(monkeypatch):
    """An explicit ``cfg.backend="numpy"`` takes the host path though the
    sweep-level backend defaults to torch (the PipelineConfig contract)."""
    def boom(*a, **k):
        raise AssertionError("torch path taken despite cfg.backend='numpy'")

    monkeypatch.setattr(pipelining_torch, "schedule_batch", boom)
    rng = np.random.default_rng(4)
    pt = t_sweep.PipelinePoint(_random_segments(rng, n=2), 3)
    rec = t_sweep.pipeline_sweep(
        [pt], t_pipe.PipelineConfig(engine="vectorized", backend="numpy"),
        cache=False)[0]
    ms, _ = _serial_starts_array(pt.segments, pt.batch)
    assert rec.pipelined == ms


def test_pipeline_sweep_milp_runs_per_point():
    segs = [("a", 1.0, 2.0, 1.0), ("b", 0.5, 1.0, 0.5)]
    pt = t_sweep.PipelinePoint(segs, 3)
    greedy, _ = j_pipe.list_schedule(j_pipe.build_jobs(segs, 3))
    rec = t_sweep.pipeline_sweep(
        [pt], t_pipe.PipelineConfig(engine="milp", time_limit=5.0),
        cache=False)[0]
    assert rec.engine == "milp"
    assert rec.pipelined <= greedy + 1e-12


def test_pipeline_sweep_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "store.bin")
    pts = _sweep_points("torch")
    recs = t_sweep.pipeline_sweep(pts, device="cpu", checkpoint=path,
                                  checkpoint_every=4)
    t_sweep.clear_cache()
    again = t_sweep.pipeline_sweep(pts, device="cpu", checkpoint=path)
    assert t_sweep.cache_stats() == {"hits": len(pts), "misses": 0}
    assert [r.pipelined for r in recs] == [r.pipelined for r in again]
