"""The port's float64 torch evaluator (``repro_torch.core.evaluator_torch``)
on the CPU against the JAX package's numpy evaluator, on the same
HWConfig / Task built in each package from the same numbers and the same
seeded numpy genomes. The torch backend sums in another order than numpy
does, so it is held to the JAX backends' contract, rtol 1e-9 (DESIGN.md
§8); its constant bundle equals the JAX package's bit for bit."""
import itertools

import numpy as np
import pytest
import torch

from repro.core import evaluator as j_ev
from repro.core import hw as j_hw
from repro.core import workload as j_wl
from repro_torch.core import evaluator as t_ev
from repro_torch.core import evaluator_torch
from repro_torch.core import hw as t_hw
from repro_torch.core import workload as t_wl

RTOL = 1e-9

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
OPTIONS = [dict(redistribution=r, async_exec=a, energy_mode=e)
           for r, a, e in itertools.product(
               (False, True), (False, True), ("paper", "per_chiplet"))]
CONFIGS = [(t, g) for t in "ABCD" for g in (2, 4)]


def _pair(mcm, grid, memory="hbm", diagonal=False, ops=OPS):
    jh = j_hw.make_hw(mcm, grid, memory, diagonal_links=diagonal)
    th = t_hw.make_hw(mcm, grid, memory, diagonal_links=diagonal)
    jt = j_wl.Task("t", [j_wl.GemmOp(**o) for o in ops])
    tt = t_wl.Task("t", [t_wl.GemmOp(**o) for o in ops])
    return (jt, jh), (tt, th)


def _population(task, hw, pop, seed):
    """Sum-exact random partitions around uniform (unit moves of up to 8
    rows/cols), random collectors and redistribution bits: numpy arrays
    both packages take."""
    rng = np.random.default_rng(seed)
    base = j_wl.uniform_partition(task, hw.X, hw.Y)
    Px = np.repeat(base.Px[None], pop, 0).astype(np.float64)
    Py = np.repeat(base.Py[None], pop, 0).astype(np.float64)
    for arr in (Px, Py):
        for p in range(1, pop):
            for i in range(arr.shape[1]):
                d, r = rng.choice(arr.shape[2], 2, replace=False)
                move = min(arr[p, i, d], rng.integers(0, 9))
                arr[p, i, d] -= move
                arr[p, i, r] += move
    coll = rng.integers(0, hw.Y, (pop, len(task)))
    redist = (rng.random((pop, len(task))) < 0.6).astype(np.float64)
    return Px, Py, coll, redist


def _close(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == np.float64, key
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=0,
                                   err_msg=key)


@pytest.mark.parametrize("opts", OPTIONS,
                         ids=lambda o: "-".join(str(v) for v in o.values()))
@pytest.mark.parametrize("mcm,grid", CONFIGS,
                         ids=[f"{t}{g}x{g}" for t, g in CONFIGS])
def test_batch_evaluate_matches_numpy(mcm, grid, opts):
    (jt, jh), (tt, th) = _pair(mcm, grid, diagonal=grid == 4)
    Px, Py, coll, rd = _population(jt, jh, 12, seed=grid * 10 + ord(mcm))
    want = j_ev.Evaluator(jt, jh, j_ev.EvalOptions(**opts)
                          ).evaluate_batch(Px, Py, coll, rd)
    ev = t_ev.Evaluator(tt, th, t_ev.EvalOptions(**opts), backend="torch",
                        device="cpu")
    _close(ev.evaluate_batch(Px, Py, coll, rd), want)


@pytest.mark.parametrize("mcm,grid", CONFIGS,
                         ids=[f"{t}{g}x{g}" for t, g in CONFIGS])
def test_consts_equal_jax_bitwise(mcm, grid):
    (jt, jh), (tt, th) = _pair(mcm, grid)
    want = j_ev.Evaluator(jt, jh).consts()
    got = t_ev.Evaluator(tt, th).consts()
    assert set(got) - set(want) == {"flow_routes"}
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("opts", OPTIONS[1::3],
                         ids=lambda o: "-".join(str(v) for v in o.values()))
@pytest.mark.parametrize("mcm", "ABCD")
def test_grid_evaluate_stacks_configs(mcm, opts):
    """G = 3 configurations of one shape (memory, links, ops' dims differ)
    in one call equal each one's numpy evaluation."""
    variants = [dict(memory="hbm"), dict(memory="dram", diagonal=True),
                dict(memory="hbm", ops=[dict(o, M=o["M"] + 16, N=o["N"] + 8)
                                        for o in OPS])]
    pairs = [_pair(mcm, 4, **v) for v in variants]
    stacked, genomes, want = [], [], []
    for g, ((jt, jh), (tt, th)) in enumerate(pairs):
        Px, Py, coll, rd = _population(jt, jh, 10, seed=g)
        genomes.append((Px, Py, coll, rd))
        want.append(j_ev.Evaluator(jt, jh, j_ev.EvalOptions(**opts)
                                   ).evaluate_batch(Px, Py, coll, rd))
        stacked.append(t_ev.Evaluator(tt, th).consts())
    consts = {k: np.stack([c[k] for c in stacked]) for k in stacked[0]}
    got = evaluator_torch.grid_evaluate(
        consts, t_ev.EvalOptions(**opts),
        *(np.stack([gen[i] for gen in genomes]) for i in range(4)),
        device="cpu")
    for g in range(len(pairs)):
        _close({k: v[g] for k, v in got.items()}, want[g])


def test_auto_backend_switches_at_the_threshold():
    """"auto" scores populations below the threshold on numpy and the
    rest on torch (on the given device), with the same numbers."""
    (jt, jh), (tt, th) = _pair("B", 2)
    opts = dict(redistribution=True, async_exec=True)
    ev = t_ev.Evaluator(tt, th, t_ev.EvalOptions(**opts), backend="auto",
                        device="cpu")
    calls = evaluator_torch.grid_evaluate.calls
    for pop, torch_calls in ((t_ev.AUTO_POPULATION_THRESHOLD - 1, 0),
                             (t_ev.AUTO_POPULATION_THRESHOLD, 1)):
        Px, Py, coll, rd = _population(jt, jh, pop, seed=pop)
        before = calls["cpu"]
        got = ev.evaluate_batch(Px, Py, coll, rd)
        assert calls["cpu"] - before == torch_calls
        _close(got, j_ev.Evaluator(jt, jh, j_ev.EvalOptions(**opts)
                                   ).evaluate_batch(Px, Py, coll, rd))
    assert t_ev.resolve_auto_backend("numpy", 10**6) == "numpy"
    assert t_ev.resolve_auto_backend("torch", 1) == "torch"
    with pytest.raises(ValueError, match="backend"):
        t_ev.Evaluator(tt, th, backend="jax")


def test_torch_backend_needs_a_card_unless_cpu(monkeypatch):
    """``device=None`` means the card: without one the torch backend (and
    "auto" at a torch-sized population) raises, never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (jt, jh), (tt, th) = _pair("A", 2)
    Px, Py, coll, rd = _population(jt, jh, t_ev.AUTO_POPULATION_THRESHOLD,
                                   seed=0)
    for backend in ("torch", "auto"):
        ev = t_ev.Evaluator(tt, th, backend=backend)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ev.evaluate_batch(Px, Py, coll, rd)
    ev = t_ev.Evaluator(tt, th, backend="torch", device="cpu")
    assert ev.evaluate_batch(Px[:2], Py[:2], coll[:2], rd[:2])[
        "latency"].shape == (2,)
