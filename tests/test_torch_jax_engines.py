"""The port's batched engines held against the JAX package's own JAX
engines, not only its numpy modules: ``evaluator_jax.grid_evaluate`` /
``batch_evaluate`` (congestion "regime" and "flow", MCM types A-D),
``netsim_jax.simulate_pull_batch``, ``pipelining_jax.schedule_batch``,
``miqp_jax``'s scorer and ``solve_lattice_batch``, and one chunk of
``ga_jax``'s generation step, whose draws the port's ``ga_torch._step``
is fed. The same numpy inputs from a seed go to both sides; the port
runs on the CPU. Contract: DESIGN.md §8's float64 rtol 1e-9, and
schedules, genes, assignments and step counts equal.

The JAX engines enter ``jax.experimental.enable_x64``, which jax 0.9
lacks; the ``x64`` fixture points it at ``jax.enable_x64(True)`` for one
test at a time (monkeypatch undoes it), as in test_torch_cosearch.py."""
import dataclasses

import jax
import jax.experimental  # noqa: F401  (the attribute the fixture sets)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from repro import graphs as j_graphs
from repro.core import evaluator as j_ev
from repro.core import evaluator_jax as j_evj
from repro.core import ga as j_ga
from repro.core import ga_jax as j_gaj
from repro.core import hw as j_hw
from repro.core import miqp as j_miqp
from repro.core import miqp_jax as j_lat
from repro.core import netsim_jax as j_net
from repro.core import pipelining_jax as j_pipe
from repro.core import workload as j_wl
from repro_torch import graphs as t_graphs
from repro_torch.core import evaluator as t_ev
from repro_torch.core import evaluator_torch
from repro_torch.core import ga as t_ga
from repro_torch.core import ga_torch as t_gat
from repro_torch.core import hw as t_hw
from repro_torch.core import miqp as t_miqp
from repro_torch.core import miqp_lattice as t_lat
from repro_torch.core import netsim_torch as t_net
from repro_torch.core import pipelining_torch as t_pipe
from repro_torch.core import workload as t_wl

RTOL = 1e-9
CPU = torch.device("cpu")
# The JAX suite's small chain (tests/test_congestion_flow.py's flow toy
# widened): chained pairs for redistribution, a sync op, ragged dims.
OPS = [
    dict(name="a", M=96, K=64, N=80),
    dict(name="b", M=96, K=80, N=48, chained=True, sync=True,
         epilogue_flops_per_elem=5),
    dict(name="c", M=90, K=48, N=70, chained=True, shared_row=True),
    dict(name="d", M=64, K=40, N=56, chained=True),
]


@pytest.fixture
def x64(monkeypatch):
    """JAX's engines, scoped to one test: their ``enable_x64`` entry
    point mapped to jax 0.9's ``jax.enable_x64(True)``."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)
    yield jax.experimental.enable_x64


def _pair(mcm, grid=4, memory="hbm", congestion="regime"):
    """The same task and HWConfig built in each package, with each
    package's evaluator options."""
    kw = dict(redistribution=True, async_exec=True, congestion=congestion)
    jh = j_hw.make_hw(mcm, grid, memory)
    th = t_hw.make_hw(mcm, grid, memory)
    jt = j_wl.Task("t", [j_wl.GemmOp(**o) for o in OPS])
    tt = t_wl.Task("t", [t_wl.GemmOp(**o) for o in OPS])
    return (jt, jh, j_ev.EvalOptions(**kw)), (tt, th, t_ev.EvalOptions(**kw))


def _population(task, hw, pop, seed):
    """Sum-exact random partitions around uniform, random collectors and
    redistribution bits (numpy, float64)."""
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
    coll = rng.integers(0, hw.Y, (pop, len(task))).astype(np.float64)
    redist = (rng.random((pop, len(task))) < 0.6).astype(np.float64)
    return Px, Py, coll, redist


def _close(got, want, rtol=RTOL):
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=0,
                                   err_msg=key)


# ------------------------------------------------------------ evaluator
@pytest.mark.parametrize("congestion", ["regime", "flow"])
@pytest.mark.parametrize("mcm", "ABCD")
def test_batch_evaluate_matches_jax(x64, mcm, congestion):
    (jt, jh, jo), (tt, th, to) = _pair(mcm, congestion=congestion)
    genomes = _population(jt, jh, 12, seed=ord(mcm))
    want = j_evj.batch_evaluate(j_ev.Evaluator(jt, jh, jo).consts(), jo,
                                *genomes)
    got = evaluator_torch.batch_evaluate(t_ev.Evaluator(tt, th, to).consts(),
                                         to, *genomes, device="cpu")
    _close(got, want)


@pytest.mark.parametrize("congestion", ["regime", "flow"])
def test_grid_evaluate_matches_jax(x64, congestion):
    """G = 2 configurations of one shape (HBM and DRAM) in one call."""
    sides = [_pair("A", memory=m, congestion=congestion)
             for m in ("hbm", "dram")]
    genomes = [_population(j[0], j[1], 8, seed=g)
               for g, (j, _) in enumerate(sides)]
    stack = [np.stack([gen[i] for gen in genomes]) for i in range(4)]

    def consts(k):
        cs = [j_ev.Evaluator(*s[k]).consts() if k == 0
              else t_ev.Evaluator(*s[k]).consts() for s in sides]
        return {n: np.stack([c[n] for c in cs]) for n in cs[0]}
    want = j_evj.grid_evaluate(consts(0), sides[0][0][2], *stack)
    got = evaluator_torch.grid_evaluate(consts(1), sides[0][1][2], *stack,
                                        device="cpu")
    _close(got, want)


# ----------------------------------------------------------------- netsim
def _flows(seed, G=3, F=8, L=12):
    """Random flow problems: link capacities, each flow's links (at
    least one), message bytes (one flow of 0 bytes)."""
    rng = np.random.default_rng(seed)
    inc = (rng.random((G, F, L)) < 0.3).astype(np.float64)
    inc[:, np.arange(F), rng.integers(0, L, F)] = 1.0
    caps = rng.uniform(1e9, 1e10, (G, L))
    msgs = rng.uniform(1e3, 1e6, (G, F))
    msgs[:, 0] = 0.0
    return caps, inc, msgs


@pytest.mark.parametrize("seed", [0, 1])
def test_netsim_simulate_pull_batch_matches_jax(x64, seed):
    caps, inc, msgs = _flows(seed)
    want = j_net.simulate_pull_batch(caps, inc, msgs)
    got = t_net.simulate_pull_batch(caps, inc, msgs, device="cpu")
    _close(got, want)
    assert np.all(np.isfinite(want["latency"]))


# ------------------------------------------------------------- pipelining
@pytest.mark.parametrize("n,batch", [(4, 3), (6, 5)])
def test_schedule_batch_matches_jax(x64, n, batch):
    """Makespans and every job's start equal, on random durations with
    ties (durations on a 0.25 grid)."""
    rng = np.random.default_rng(n)
    seg = np.round(4 * rng.uniform(0.0, 3.0, (4, n, 3))) / 4
    want = j_pipe.schedule_batch(seg, batch)
    got = t_pipe.schedule_batch(seg, batch, device="cpu")
    np.testing.assert_array_equal(got["makespan"], want["makespan"])
    np.testing.assert_array_equal(got["starts"], want["starts"])


# ---------------------------------------------------------------- lattice
MIQP = dict(engine="lattice", candidate_budget=256, eval_budget=1024,
            beam_width=4, refine_sweeps=1, pair_refine=4, descent_sweeps=2,
            score_chunk=256)


def _alex(pkg, lo, hi):
    """The JAX suite's AlexNet slice (first op unchained)."""
    graphs, wl = (j_graphs, j_wl) if pkg == "jax" else (t_graphs, t_wl)
    ops = list(graphs.WORKLOADS["alexnet"](batch=1).ops[lo:hi])
    ops[0] = dataclasses.replace(ops[0], chained=False)
    return wl.Task(f"alex{lo}", ops)


def _lattice_points(pkg):
    hw = (j_hw if pkg == "jax" else t_hw).make_hw("A", 2, "hbm")
    opts = (j_ev if pkg == "jax" else t_ev).EvalOptions(
        redistribution=True, async_exec=True)
    return [_alex(pkg, 0, 4), _alex(pkg, 1, 5)], [hw, hw], opts


def test_lattice_scorer_matches_jax(x64):
    """Random candidate assignments of two points, scored in one call on
    each side."""
    jtasks, jhws, jo = _lattice_points("jax")
    ttasks, thws, to = _lattice_points("torch")
    jcfg = j_miqp.MIQPConfig(**MIQP, backend="jax")
    tcfg = t_miqp.MIQPConfig(**MIQP, backend="torch", device="cpu")
    jsp = [j_lat._Space(t, h, jcfg) for t, h in zip(jtasks, jhws)]
    tsp = [t_lat._Space(t, h, tcfg) for t, h in zip(ttasks, thws)]
    assert [s.sizes for s in jsp] == [s.sizes for s in tsp]
    rng = np.random.default_rng(0)
    assign = np.stack([np.stack([rng.integers(0, k, 40) for k in s.sizes],
                                axis=1) for s in jsp])       # [G, P, n]
    for obj in ("latency", "edp"):
        want = j_lat._GroupScorer(jtasks, jhws, jsp, jo, obj, "jax",
                                  64).score(assign)
        got = t_lat._GroupScorer(ttasks, thws, tsp, to, obj, "torch", 64,
                                 device="cpu").score(assign)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_solve_lattice_batch_matches_jax(x64):
    """The whole batched solve on both sides: objectives at rtol 1e-9,
    the same partitions and redistribution masks."""
    jtasks, jhws, jo = _lattice_points("jax")
    ttasks, thws, to = _lattice_points("torch")
    want = j_lat.solve_lattice_batch(
        jtasks, jhws, jo, "latency", j_miqp.MIQPConfig(**MIQP,
                                                       backend="jax"))
    got = t_lat.solve_lattice_batch(
        ttasks, thws, to, "latency",
        t_miqp.MIQPConfig(**MIQP, backend="torch", device="cpu"))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.objective, b.objective, rtol=RTOL,
                                   atol=0)
        np.testing.assert_array_equal(a.partition.Px, b.partition.Px)
        np.testing.assert_array_equal(a.partition.Py, b.partition.Py)
        np.testing.assert_array_equal(a.partition.collectors,
                                      b.partition.collectors)
        np.testing.assert_array_equal(a.redist_mask, b.redist_mask)


# --------------------------------------------------------------------- GA
GA = dict(population=16, elite=3, tournament=3, patience=5, seed=0)


def test_ga_chunk_on_jax_draws_matches_jax(x64):
    """Two islands (AlexNet slices on a 2x2 type-A mesh), one chunk of
    four generations: JAX's compiled chunk (``ga_jax._chunk_fn``) against
    ``ga_torch._step`` fed the uniform draws JAX's step makes from each
    generation's key. Genes, best genomes and step counts equal; the
    best objectives, each generation's and the carry's, at rtol 1e-9."""
    L, objective = 4, "latency"
    jtasks, jhws, jo = _lattice_points("jax")
    ttasks, thws, to = _lattice_points("torch")
    jcfg, tcfg = j_ga.GAConfig(**GA), t_ga.GAConfig(**GA)
    pop, elite, Q = jcfg.population, jcfg.elite, jcfg.population - jcfg.elite
    n, X, Y = len(jtasks[0]), jhws[0].X, jhws[0].Y
    inits = [j_ga._random_population_vec(np.random.default_rng(jcfg.seed),
                                         t, h, jcfg, pop)
             for t, h in zip(jtasks, jhws)]
    pop0 = [np.stack([i[j] for i in inits]).astype(np.float64)
            for j in range(4)]

    def stacked(evs):
        cs = [ev.consts() for ev in evs]
        return {k: np.stack([c[k] for c in cs]) for k in cs[0]}
    win = {"lo_x": [], "hi_x": [], "lo_y": [], "hi_y": []}
    for t, h in zip(jtasks, jhws):
        lo, hi = j_wl.partition_domain(t, h.X, h.Y, h.R, h.C, jcfg.slack)
        for k, v in (("lo_x", lo[:, 0]), ("hi_x", hi[:, 0]),
                     ("lo_y", lo[:, 1]), ("hi_y", hi[:, 1])):
            win[k].append(v)
    win = {k: np.stack(v).astype(np.float64) for k, v in win.items()}
    hp = {"p_crossover": jcfg.p_crossover,
          "p_mutate_partition": jcfg.p_mutate_partition,
          "p_mutate_collector": jcfg.p_mutate_collector,
          "p_mutate_redist": jcfg.p_mutate_redist,
          "patience": jcfg.patience}
    statics = (elite, jcfg.tournament, jcfg.freeze_redist, objective,
               jo.redistribution, jo.async_exec, jo.energy_mode,
               jo.congestion)
    G = len(jtasks)
    with x64():
        f8 = lambda a: jnp.asarray(a, dtype=jnp.float64)  # noqa: E731
        carry = (*map(f8, pop0), jnp.full((G,), jnp.inf, jnp.float64),
                 jnp.zeros((G, n, X), jnp.float64),
                 jnp.zeros((G, n, Y), jnp.float64),
                 jnp.zeros((G, n), jnp.float64),
                 jnp.zeros((G, n), jnp.float64),
                 jnp.zeros((G,), jnp.int32), jnp.zeros((G,), jnp.int32))
        keys = random.split(random.PRNGKey(7), L)
        out_j, (yb, _) = j_gaj._chunk_fn(*statics)(
            {k: jnp.asarray(v) for k, v in stacked(
                [j_ev.Evaluator(t, h, jo) for t, h in
                 zip(jtasks, jhws)]).items()},
            {k: jnp.asarray(v) for k, v in win.items()}, hp, carry, keys)
        draws = []
        for key in keys:
            kt, km, kv = random.split(key, 3)
            draws.append(tuple(torch.from_numpy(np.array(u)) for u in (
                random.uniform(kt, (2, Q, jcfg.tournament)),
                random.uniform(km, (7, Q, n)),
                random.uniform(kv, (4, t_gat.MOVE_ATTEMPTS, Q, n)))))
        out_j = [np.asarray(leaf) for leaf in out_j]
        yb = np.asarray(yb)

    consts = evaluator_torch.to_device(stacked(
        [t_ev.Evaluator(t, h, to) for t, h in zip(ttasks, thws)]), CPU)
    win_t = {k: torch.from_numpy(v) for k, v in win.items()}
    carry_t = {k: torch.from_numpy(a) for k, a in
               zip(("Px", "Py", "co", "rd"), pop0)}
    carry_t.update({
        "best_obj": torch.full((G,), float("inf"), dtype=torch.float64),
        "bPx": torch.zeros((G, n, X), dtype=torch.float64),
        "bPy": torch.zeros((G, n, Y), dtype=torch.float64),
        "bco": torch.zeros((G, n), dtype=torch.float64),
        "brd": torch.zeros((G, n), dtype=torch.float64),
        "flat": torch.zeros((G,), dtype=torch.int64),
        "steps": torch.zeros((G,), dtype=torch.int64)})
    hist = []
    for d in draws:
        assert d[0].dtype == torch.float64
        carry_t = t_gat._step(consts, win_t, tcfg, to, objective, elite, d,
                              carry_t)
        hist.append(carry_t["best_obj"].numpy())
    np.testing.assert_allclose(np.stack(hist, 1), yb, rtol=RTOL, atol=0)
    names = ("Px", "Py", "co", "rd", "best_obj", "bPx", "bPy", "bco", "brd",
             "flat", "steps")
    for name, want in zip(names, out_j):
        got = carry_t[name].numpy()
        if name == "best_obj":
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
        else:
            np.testing.assert_array_equal(got, want.astype(got.dtype),
                                          err_msg=name)
    assert np.isfinite(out_j[4]).all()
