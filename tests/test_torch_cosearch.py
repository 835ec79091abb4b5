"""The port's fused co-search (``repro_torch.core.cosearch``, DESIGN.md
§16) held against the JAX package's ``repro.core.cosearch`` itself, on
the JAX suite's tiny shape (tests/test_core_cosearch.py: AlexNet ops
0-3 on a 2x2 type-A HBM mesh with redistribution and async execution)
and a second 4-op task for the island cases.

The JAX engines enter ``jax.experimental.enable_x64``, which jax 0.9
lacks; the ``x64`` fixture points it at ``jax.enable_x64(True)`` for one
test at a time (monkeypatch undoes it), so no other test sees it.

Contracts: the fused fitness (regime and flow, with and without a
segment overhead), the smooth relaxation's values and gradients, the
gradient descent from JAX's own starts, the archive ranking and a
3-generation chunk fed JAX's draws agree with JAX at rtol 1e-9 (genes
and archives equal); a whole search on the CPU is valid, re-scores by
the numpy evaluator and the serial SGS, and comes within 1% of JAX's
best EDP; solo == batched == served == sharded bit for bit; the cache,
seed and lattice-anchor hooks follow the JAX suite's contract."""
import dataclasses

import jax
import jax.experimental  # noqa: F401  (the attribute the fixture sets)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from repro import graphs as j_graphs
from repro.core import cosearch as j_cs
from repro.core import hw as j_hw
from repro.core import miqp as j_miqp
from repro.core import miqp_jax as j_lat
from repro.core import workload as j_wl
from repro.core.evaluator import EvalOptions as JOpts
from repro_torch import graphs as t_graphs
from repro_torch.core import api as t_api
from repro_torch.core import cosearch as t_cs
from repro_torch.core import evaluator as t_ev
from repro_torch.core import evaluator_torch
from repro_torch.core import ga as t_ga
from repro_torch.core import hw as t_hw
from repro_torch.core import miqp as t_miqp
from repro_torch.core import miqp_lattice as t_lat
from repro_torch.core import pipelining as t_pipe
from repro_torch.core import pipelining_torch as t_pipe_t
from repro_torch.core import sweep as t_sweep
from repro_torch.core import sweep_shard
from repro_torch.core import workload as t_wl
from repro_torch.serve import OptRequest, OptServer

RTOL = 1e-9
CPU = torch.device("cpu")
CFG = dict(population=16, generations=10, patience=10, batch=3, seed=0,
           seed_steps=4, seed_starts=2, archive_size=8)
T_CFG = t_cs.CoSearchConfig(**CFG, device="cpu")
J_CFG = j_cs.CoSearchConfig(**CFG)
MIQP = dict(engine="lattice", candidate_budget=256, eval_budget=1024,
            beam_width=4, refine_sweeps=1, pair_refine=4, descent_sweeps=2,
            score_chunk=256)


@pytest.fixture
def x64(monkeypatch):
    """JAX's co-search, scoped to one test: its ``enable_x64`` entry
    point mapped to jax 0.9's ``jax.enable_x64(True)``."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)
    yield jax.experimental.enable_x64


@pytest.fixture(autouse=True)
def _fresh_cache():
    t_sweep.clear_cache()
    yield
    t_sweep.clear_cache()


def task(pkg, name="alex4", lo=0, hi=4):
    """The JAX suite's AlexNet slice (first op unchained)."""
    graphs, wl = (j_graphs, j_wl) if pkg == "jax" else (t_graphs, t_wl)
    ops = list(graphs.WORKLOADS["alexnet"](batch=1).ops[lo:hi])
    ops[0] = dataclasses.replace(ops[0], chained=False)
    return wl.Task(name, ops)


def hw(pkg, diag=False):
    return (j_hw if pkg == "jax" else t_hw).make_hw(
        "A", 2, "hbm", diagonal_links=diag)


def opts(pkg, congestion="regime"):
    cls = JOpts if pkg == "jax" else t_ev.EvalOptions
    return cls(redistribution=True, async_exec=True, congestion=congestion)


TASKS = (("alex4", 0, 4), ("alex4b", 1, 5))


def _same_result(a, b):
    assert a.objective == b.objective
    assert (a.edp, a.latency, a.energy) == (b.edp, b.latency, b.energy)
    assert a.diagonal == b.diagonal
    np.testing.assert_array_equal(a.partition.Px, b.partition.Px)
    np.testing.assert_array_equal(a.partition.Py, b.partition.Py)
    np.testing.assert_array_equal(a.partition.collectors,
                                  b.partition.collectors)
    np.testing.assert_array_equal(a.redist_mask, b.redist_mask)
    np.testing.assert_array_equal(a.seg_mask, b.seg_mask)
    assert set(a.front) == set(b.front)
    for k in a.front:
        np.testing.assert_array_equal(a.front[k], b.front[k])
    np.testing.assert_array_equal(a.history, b.history)
    assert a.evaluations == b.evaluations


def _consts(pkg, congestion="regime"):
    mod = j_cs if pkg == "jax" else t_cs
    return mod._consts_pair(task(pkg), hw(pkg), opts(pkg, congestion))


def _stack(bundles):
    return {k: np.stack([b[k] for b in bundles]) for k in bundles[0]}


def _device(c, keys=None):
    keys = c.keys() if keys is None else keys
    return evaluator_torch.to_device({k: c[k][None] for k in keys}, CPU)


# ------------------------------------------------------ fused fitness
def _genomes(P, seed):
    """``P`` genomes of the tiny task, sampled with numpy: the shared GA
    init's partitions and collectors, random redist, diag and seg."""
    t, h = task("torch"), hw("torch")
    rng = np.random.default_rng(seed)
    Px, Py, co, _ = t_ga._random_population_vec(rng, t, h, T_CFG, P)
    n = len(t)
    return (Px.astype(np.float64), Py.astype(np.float64),
            co.astype(np.float64),
            (rng.random((P, n)) < 0.5).astype(np.float64),
            (rng.random(P) < 0.5).astype(np.float64),
            (rng.random((P, n)) < 0.5).astype(np.float64))


@pytest.mark.parametrize("seg_overhead", [0.0, 1e-6])
@pytest.mark.parametrize("congestion", ["regime", "flow"])
def test_fused_fitness_matches_jax(x64, congestion, seg_overhead):
    genes = _genomes(32, seed=1 + (congestion == "flow"))
    cp_j, cd_j, _ = _consts("jax", congestion)
    cp_t, cd_t, _ = _consts("torch", congestion)
    fit = j_cs._fitness_one(3, True, True, JOpts().energy_mode, congestion,
                            False)
    with x64():
        vfit = jax.jit(jax.vmap(fit, in_axes=(None, None, None) + (0,) * 6))
        ref = np.asarray(vfit({k: jnp.asarray(v) for k, v in cp_j.items()},
                              {k: jnp.asarray(v) for k, v in cd_j.items()},
                              jnp.asarray(seg_overhead),
                              *[jnp.asarray(g) for g in genes]))
    Px, Py, co, rd, dg, sg = (torch.from_numpy(g)[None] for g in genes)
    got = t_cs._fitness(_device(cp_t), _device(cd_t, t_cs.DIAG_KEYS),
                        seg_overhead, Px, Py, co, rd, dg, sg, batch=3,
                        options=opts("torch", congestion), smooth=False)
    assert got.shape == (1, 32, 3) and ref.shape == (32, 3)
    np.testing.assert_allclose(got[0].numpy(), ref, rtol=RTOL, atol=0)


def test_device_priorities_and_makespan_match_the_host_engines():
    """``pipelining_torch.chain_priorities`` is the host's reversed
    cumulative sum bit for bit (on the CPU), and ``sgs_makespan`` the
    batched SGS's makespan on the same instances, zero-duration tail
    slots included."""
    rng = np.random.default_rng(5)
    dur = rng.uniform(0.0, 2.0, (6, 12))
    dur[:, 9:] = 0.0
    prio = t_pipe_t.chain_priorities(torch.from_numpy(dur)).numpy()
    np.testing.assert_array_equal(
        prio, np.stack([t_pipe.chain_priorities(d) for d in dur]))
    got = t_pipe_t.sgs_makespan(torch.from_numpy(dur), 3).numpy()
    want = t_pipe_t.schedule_batch(dur.reshape(6, 4, 3), 3,
                                   device="cpu")["makespan"]
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------- smooth relaxation
def _jax_loss(oi=0):
    """JAX's seeding objective of one start (``cosearch._descend_fn``)."""
    fit = j_cs._fitness_one(3, True, True, JOpts().energy_mode, "regime",
                            True)

    def loss(p, cpj, cdj, so, Mj, Nj, cov, rdv, sgv):
        Px = jax.nn.softmax(p["lx"], axis=-1) * Mj
        Py = jax.nn.softmax(p["ly"], axis=-1) * Nj
        w = jax.nn.sigmoid(p["t"])
        return fit(cpj, cdj, so, Px, Py, cov, rdv, w, sgv)[oi]
    return loss


def _jax_seed_args(x64):
    """The fixed descent inputs exactly as ``j_cs.gradient_seeds`` builds
    them."""
    t, h = task("jax"), hw("jax")
    cp, cd, evp = _consts("jax")
    n = len(t)
    with x64():
        return ({k: jnp.asarray(v) for k, v in cp.items()},
                {k: jnp.asarray(v) for k, v in cd.items()},
                jnp.asarray(0.0),
                jnp.asarray(np.asarray(evp.M, dtype=np.float64))[:, None],
                jnp.asarray(np.asarray(evp.N, dtype=np.float64))[:, None],
                jnp.asarray(np.full(n, h.Y // 2, dtype=np.float64)),
                jnp.asarray(np.asarray(evp.chain_valid, dtype=np.float64)),
                jnp.asarray(np.ones(n)))


def _jax_p0(x64, S=2):
    """JAX's own descent starts (``j_cs.gradient_seeds``)."""
    n, X, Y = 4, 2, 2
    with x64():
        k1, k2, k3 = random.split(random.PRNGKey(J_CFG.seed), 3)
        p0 = {"lx": 0.5 * random.normal(k1, (S, n, X), dtype=jnp.float64),
              "ly": 0.5 * random.normal(k2, (S, n, Y), dtype=jnp.float64),
              "t": random.normal(k3, (S,), dtype=jnp.float64)}
        p0 = {k: v.at[0].set(0.0) for k, v in p0.items()}
        return {k: np.array(v) for k, v in p0.items()}


@pytest.mark.parametrize("start", ["zeros", "random"])
def test_smooth_values_and_gradients_match_jax(x64, start):
    """Values and gradients w.r.t. the logits and ``t``; the all-zero
    start is the neutral point, full of tied maxima."""
    p0 = _jax_p0(x64, S=3)
    if start == "zeros":
        p0 = {k: np.zeros_like(v) for k, v in p0.items()}
    args = _jax_seed_args(x64)
    with x64():
        vg = jax.vmap(jax.value_and_grad(_jax_loss()),
                      in_axes=(0,) + (None,) * 8)
        val, grad = vg({k: jnp.asarray(v) for k, v in p0.items()}, *args)
        val = np.asarray(val)
        grad = {k: np.asarray(v) for k, v in grad.items()}
    prob = t_cs._seed_problem(task("torch"), hw("torch"), opts("torch"),
                              T_CFG)
    leaves = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in p0.items()}
    loss = t_cs._smooth_loss(prob, leaves, 0, T_CFG)
    g = torch.autograd.grad(loss.sum(), list(leaves.values()))
    np.testing.assert_allclose(loss.detach().numpy(), val, rtol=RTOL,
                               atol=0)
    for (k, _), gk in zip(leaves.items(), g):
        assert np.isfinite(gk.numpy()).all()
        np.testing.assert_allclose(gk.numpy(), grad[k], rtol=RTOL,
                                   atol=RTOL * np.abs(grad[k]).max())


def test_smooth_rejects_flow():
    cp, cd, _ = _consts("torch", "flow")
    Px, Py, co, rd, dg, sg = (torch.from_numpy(g)[None]
                              for g in _genomes(2, 0))
    with pytest.raises(ValueError, match="regime"):
        t_cs._fitness(_device(cp), _device(cd, t_cs.DIAG_KEYS), 0.0, Px,
                      Py, co, rd, dg, sg, batch=3,
                      options=opts("torch", "flow"), smooth=True)


def test_descent_from_jax_starts_matches(x64):
    """``seed_steps`` = 4 normalized steps from JAX's ``p0``: ``pT``
    agrees at rtol 1e-9 and the rounded proposals are equal."""
    p0 = _jax_p0(x64)
    args = _jax_seed_args(x64)
    descend = j_cs._descend_fn(3, True, True, JOpts().energy_mode, 0, 4)
    with x64():
        pT = descend({k: jnp.asarray(v) for k, v in p0.items()}, *args,
                     jnp.asarray(J_CFG.seed_lr))
        pT = {k: np.asarray(v) for k, v in pT.items()}
        j_seeds = j_cs.gradient_seeds(task("jax"), hw("jax"), opts("jax"),
                                      "edp", J_CFG)
    prob = t_cs._seed_problem(task("torch"), hw("torch"), opts("torch"),
                              T_CFG)
    p0_t = {k: torch.from_numpy(v) for k, v in p0.items()}
    got = t_cs._descend(prob, p0_t, 0, T_CFG)
    for k in pT:
        np.testing.assert_allclose(got[k].numpy(), pT[k], rtol=RTOL,
                                   atol=RTOL * np.abs(pT[k]).max())
    t_seeds = t_cs.gradient_seeds(task("torch"), hw("torch"),
                                  opts("torch"), "edp", T_CFG, p0=p0_t)
    assert len(t_seeds) == len(j_seeds) >= 1
    for (pt, dt), (pj, dj) in zip(t_seeds, j_seeds):
        np.testing.assert_array_equal(pt.Px, pj.Px)
        np.testing.assert_array_equal(pt.Py, pj.Py)
        np.testing.assert_array_equal(pt.collectors, pj.collectors)
        assert dt == dj
    # The port's own starts: deterministic, valid, start 0 neutral.
    own = t_cs.gradient_seeds(task("torch"), hw("torch"), opts("torch"),
                              "edp", T_CFG)
    again = t_cs.gradient_seeds(task("torch"), hw("torch"), opts("torch"),
                                "edp", T_CFG)
    assert [(p.Px.tobytes(), d) for p, d in own] == \
        [(p.Px.tobytes(), d) for p, d in again]
    for p, _ in own:
        p.validate(task("torch"))


# -------------------------------------------------------- archive rank
@pytest.mark.parametrize("seed", range(4))
def test_archive_rank_matches_jax(seed):
    """Random ``[K+P, 3]`` objective rows on a small integer lattice
    (exact ties and duplicates) with +inf rows: the same permutation,
    alone and batched over a leading island axis."""
    rng = np.random.default_rng(seed)
    mats = []
    for _ in range(3):
        obj = rng.integers(0, 4, size=(24, 3)).astype(np.float64)
        obj[rng.random(24) < 0.25] = np.inf
        obj[5] = obj[2]
        mats.append(obj)
    want = np.stack([np.asarray(j_cs._archive_rank(jnp.asarray(m)))
                     for m in mats])
    for g, m in enumerate(mats):
        np.testing.assert_array_equal(
            t_cs._archive_rank(torch.from_numpy(m)).numpy(), want[g])
    np.testing.assert_array_equal(
        t_cs._archive_rank(torch.from_numpy(np.stack(mats))).numpy(), want)


# ---------------------------------------------------- one chunk of 3
def test_chunk_of_three_generations_matches_jax(x64):
    """Both engines get the same carry (the shared ``_init_island``, bit
    for bit JAX's, seeded by JAX's gradient proposals) and the port gets
    JAX's draws: genes and archive equal, objectives at rtol 1e-9."""
    L, G = 3, 2
    tj = [task("jax", *spec) for spec in TASKS]
    tt = [task("torch", *spec) for spec in TASKS]
    with x64():
        seeds = [j_cs.gradient_seeds(t, hw("jax"), opts("jax"), "edp",
                                     J_CFG) for t in tj]
    inits_j = [j_cs._init_island(t, hw("jax"), opts("jax"), J_CFG, s)
               for t, s in zip(tj, seeds)]
    inits_t = [t_cs._init_island(t, hw("torch"), opts("torch"), T_CFG, s)
               for t, s in zip(tt, seeds)]
    for a, b in zip(inits_j, inits_t):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    pop0 = tuple(np.stack([i[j] for i in inits_j]).astype(np.float64)
                 for j in range(6))

    pairs_j = [j_cs._consts_pair(t, hw("jax"), opts("jax")) for t in tj]
    pairs_t = [t_cs._consts_pair(t, hw("torch"), opts("torch"))
               for t in tt]
    win = {"lo_x": [], "hi_x": [], "lo_y": [], "hi_y": []}
    for t in tt:
        h = hw("torch")
        lo, hi = t_wl.partition_domain(t, h.X, h.Y, h.R, h.C, T_CFG.slack)
        for k, v in (("lo_x", lo[:, 0]), ("hi_x", hi[:, 0]),
                     ("lo_y", lo[:, 1]), ("hi_y", hi[:, 1])):
            win[k].append(v)
    win = {k: np.stack(v).astype(np.float64) for k, v in win.items()}
    K, pop, elite = J_CFG.archive_size, J_CFG.population, J_CFG.elite
    Q, n = pop - elite, 4
    hp = {"p_crossover": J_CFG.p_crossover,
          "p_mutate_partition": J_CFG.p_mutate_partition,
          "p_mutate_collector": J_CFG.p_mutate_collector,
          "p_mutate_redist": J_CFG.p_mutate_redist,
          "p_mutate_diag": J_CFG.p_mutate_diag,
          "p_mutate_seg": J_CFG.p_mutate_seg,
          "patience": J_CFG.patience, "seg_overhead": J_CFG.seg_overhead}
    statics = (elite, J_CFG.tournament, False, 0, J_CFG.batch, True, True,
               JOpts().energy_mode, "regime")
    carry_t = t_cs._init_carry(pop0, K, CPU)
    with x64():
        carry_j = tuple(jnp.asarray(leaf.numpy()) for leaf in carry_t[:21]) \
            + (jnp.zeros(G, jnp.int32), jnp.zeros(G, jnp.int32))
        keys = random.split(random.PRNGKey(7), L)
        out_j, (yb, _) = j_cs._chunk_fn(*statics)(
            {k: jnp.asarray(np.stack([p[0][k] for p in pairs_j]))
             for k in pairs_j[0][0]},
            {k: jnp.asarray(np.stack([p[1][k] for p in pairs_j]))
             for k in pairs_j[0][1]},
            {k: jnp.asarray(v) for k, v in win.items()}, hp, carry_j, keys)
        draws = []
        for key in keys:
            kt, km, kv = random.split(key, 3)
            draws.append(tuple(torch.from_numpy(np.array(u)) for u in (
                random.uniform(kt, (2, Q, J_CFG.tournament)),
                random.uniform(km, (10, Q, n)),
                random.uniform(kv, (4, 4, Q, n)))))
        out_j = [np.asarray(leaf) for leaf in out_j]
        yb = np.asarray(yb)
    cp = evaluator_torch.to_device(_stack([p[0] for p in pairs_t]), CPU)
    cd = evaluator_torch.to_device(
        _stack([{k: p[1][k] for k in t_cs.DIAG_KEYS} for p in pairs_t]), CPU)
    win_t = {k: torch.from_numpy(v) for k, v in win.items()}
    hist = []
    for d in draws:
        assert d[0].dtype == torch.float64
        carry_t = t_cs._apply(cp, cd, win_t, carry_t, d, cfg=T_CFG,
                              options=opts("torch"), obj_idx=0, elite=elite)
        hist.append(carry_t[t_cs._BEST_OBJ].numpy())
    np.testing.assert_allclose(np.stack(hist, 1), yb, rtol=RTOL, atol=0)
    objectives = {6, t_cs._BEST_OBJ, t_cs._BEST_VEC}
    for i, (a, b) in enumerate(zip(carry_t, out_j)):
        a = a.numpy()
        if i in objectives:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=0)
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype))
    assert np.isfinite(out_j[6]).any()


# ------------------------------------------------------- whole search
def rescore(t, h, options, r, batch, seg_overhead=0.0):
    """A result's best genome through the port's numpy evaluator and the
    serial SGS (``pipelining.list_schedule``) → (edp, latency, energy)."""
    ev = t_ev.Evaluator(t, dataclasses.replace(h, diagonal_links=r.diagonal),
                        options, backend="numpy").evaluate(r.partition,
                                                           r.redist_mask)
    n = len(t)
    seg_id = np.concatenate([[0], np.cumsum(r.seg_mask[:-1])]).astype(int)
    slots = np.zeros((n, 3))
    for i in range(n):
        slots[seg_id[i]] += (ev.t_in[i], ev.t_comp[i], ev.t_out[i])
    slots[:seg_id[-1] + 1, 0] += seg_overhead
    mk, _ = t_pipe.list_schedule(t_pipe.build_jobs(
        [(f"s{k}", *slots[k]) for k in range(n)], batch))
    lat = mk / batch
    return ev.energy * lat, lat, ev.energy


def test_whole_search_valid_rescored_and_near_jax(x64):
    t, h = task("torch"), hw("torch")
    r = t_cs.run_cosearch(t, h, "edp", opts("torch"), T_CFG)
    r.partition.validate(t)
    assert r.objective == r.edp
    assert not r.seg_mask[-1]
    pts = np.stack([r.front[k] for k in t_cs.OBJECTIVES], 1)
    assert t_cs.pareto_mask(pts).all()
    assert np.array_equal(np.lexsort(pts.T[::-1]), np.arange(len(pts)))
    assert r.front["edp"].min() == r.edp
    assert len(r.history) == r.evaluations // T_CFG.population
    assert np.all(np.diff(r.history) <= 0)
    np.testing.assert_allclose(
        rescore(t, h, opts("torch"), r, T_CFG.batch),
        (r.edp, r.latency, r.energy), rtol=RTOL, atol=0)
    with x64():
        rj = j_cs.run_cosearch(task("jax"), hw("jax"), "edp", opts("jax"),
                               J_CFG)
    assert r.edp <= 1.01 * rj.edp
    with pytest.raises(ValueError, match="objective"):
        t_cs.run_cosearch(t, h, "throughput", opts("torch"), T_CFG)


def test_flow_search_rescored():
    t, h = task("torch"), hw("torch")
    o = opts("torch", "flow")
    cfg = dataclasses.replace(T_CFG, generations=4, patience=4,
                              seg_overhead=1e-6)
    r = t_cs.run_cosearch(t, h, "latency", o, cfg)
    assert r.objective == r.latency and np.isfinite(r.edp)
    np.testing.assert_allclose(rescore(t, h, o, r, cfg.batch, 1e-6),
                               (r.edp, r.latency, r.energy), rtol=RTOL,
                               atol=0)


# ------------------------------------------------------- the contract
def test_solo_batched_served_sharded_bitwise():
    ta, tb = (task("torch", *spec) for spec in TASKS)
    h, o = hw("torch"), opts("torch")
    solo = [t_cs.run_cosearch(t, h, "edp", o, T_CFG) for t in (ta, tb)]
    batched = t_cs.cosearch_islands([ta, tb], [h, h], o, "edp", T_CFG)
    with sweep_shard.use_mesh([CPU] * 2):
        sharded = t_cs.cosearch_islands([ta, tb], [h, h], o, "edp", T_CFG,
                                        devices="sharded")
    srv = OptServer(device="cpu", autostart=False)
    futs = [srv.submit(OptRequest("solve", t_sweep.EvalPoint(t, h, o),
                                  objective="edp", method="cosearch",
                                  cfg=T_CFG)) for t in (ta, tb)]
    srv.start()
    served = [f.result(timeout=60) for f in futs]
    assert srv.stats()["coalesced"] >= 1
    srv.kill()
    for s, b, sh, sv in zip(solo, batched, sharded, served):
        _same_result(s, b)
        _same_result(s, sh)
        _same_result(s, sv)


def test_sweep_cache_diag_normalized_and_front_doors():
    t, o = task("torch"), opts("torch")
    pt = t_sweep.EvalPoint(t, hw("torch"), o)
    r = t_sweep.cosearch_sweep([pt], "edp", T_CFG)[0]
    hits = t_sweep.cache_stats()["hits"]
    r_diag = t_sweep.cosearch_sweep(
        [t_sweep.EvalPoint(t, hw("torch", diag=True), o)], "edp", T_CFG)[0]
    assert t_sweep.cache_stats()["hits"] == hits + 1
    _same_result(r, r_diag)
    _same_result(r, t_sweep.solve_grid([pt], "edp", T_CFG,
                                       method="cosearch")[0])
    _same_result(r, t_api.cosearch(t, hw("torch"), "edp", o, T_CFG))
    r.front["edp"][:] = -1.0
    assert np.all(t_sweep.cosearch_sweep([pt], "edp", T_CFG)[0]
                  .front["edp"] > 0)
    with pytest.raises(TypeError):
        t_sweep.cosearch_sweep([pt], "edp", t_miqp.MIQPConfig())
    with pytest.raises(ValueError, match="torch"):
        t_sweep.cosearch_sweep([pt], "edp", T_CFG, backend="numpy")


def test_checkpointed_sweep_resumes_from_its_store(tmp_path):
    """``checkpoint=`` persists co-search records; a fresh process cache
    pointed at the store serves them as hits, equal to the originals."""
    o = opts("torch")
    pts = [t_sweep.EvalPoint(task("torch"), hw("torch"), o),
           t_sweep.EvalPoint(task("torch", "alex4b", 1, 5), hw("torch"), o)]
    store = tmp_path / "cosearch.bin"
    first = t_sweep.cosearch_sweep(pts, "edp", T_CFG, checkpoint=store,
                                   checkpoint_every=1)
    t_sweep.clear_cache()
    assert t_sweep.SweepCheckpointer(store).resumed == 2
    again = t_sweep.cosearch_sweep(pts, "edp", T_CFG)
    assert t_sweep.cache_stats() == {"hits": 2, "misses": 0}
    for a, b in zip(first, again):
        _same_result(a, b)


def test_explicit_empty_seeds_are_the_cold_start():
    t, h, o = task("torch"), hw("torch"), opts("torch")
    cold = t_cs.cosearch_islands([t], [h], o, "edp", T_CFG, seeds=[[]])[0]
    no_frac = dataclasses.replace(T_CFG, seed_fraction=0.0)
    _same_result(cold, t_cs.cosearch_islands([t], [h], o, "edp",
                                             no_frac)[0])
    with pytest.raises(ValueError, match="align"):
        t_cs.cosearch_islands([t], [h], o, "edp", T_CFG, seeds=[[], []])


def test_lattice_anchor_hooks_match_jax(x64):
    """``_repair_units``, ``axis_lattice(anchor=)`` and
    ``layer_lattice(anchor=)`` equal JAX's element for element;
    ``anchors=None`` is today's lattice bit for bit; ``miqp_anchor`` is
    a valid partition that the anchored lattice accepts."""
    rng = np.random.default_rng(3)
    for _ in range(6):
        parts = int(rng.integers(2, 5))
        lo, hi = int(rng.integers(0, 3)), int(rng.integers(4, 8))
        S = int(rng.integers(lo * parts, hi * parts + 1))
        units = rng.integers(-2, 10, parts)
        np.testing.assert_array_equal(t_lat._repair_units(units, S, lo, hi),
                                      j_lat._repair_units(units, S, lo, hi))
        for cap in (5, 64):
            for a, b in zip(t_lat.axis_lattice(S, parts, lo, hi, cap,
                                               anchor=units),
                            j_lat.axis_lattice(S, parts, lo, hi, cap,
                                               anchor=units)):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="infeasible"):
        t_lat._repair_units(np.zeros(2), 100, 0, 4)

    with x64():
        j_anchor = j_cs.miqp_anchor(task("jax"), hw("jax"), opts("jax"),
                                    "edp", J_CFG)
    t_anchor = t_cs.miqp_anchor(task("torch"), hw("torch"), opts("torch"),
                                "edp", T_CFG)
    t_anchor.validate(task("torch"))
    jcfg, tcfg = j_miqp.MIQPConfig(**MIQP), t_miqp.MIQPConfig(**MIQP)
    for a, b in zip(t_lat.layer_lattice(task("torch"), hw("torch"), tcfg,
                                        anchor=j_anchor),
                    j_lat.layer_lattice(task("jax"), hw("jax"), jcfg,
                                        anchor=j_anchor)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])

    tcfg = dataclasses.replace(tcfg, backend="torch", device="cpu")
    args = ([task("torch")], [hw("torch")], opts("torch"), "edp", tcfg)
    base = t_lat.solve_lattice_batch(*args)[0]
    for other in (t_lat.solve_lattice_batch(*args, anchors=None)[0],
                  t_lat.solve_lattice_batch(*args, anchors=[None])[0]):
        assert other.objective == base.objective
        np.testing.assert_array_equal(other.partition.Px, base.partition.Px)
    anchored = t_lat.solve_lattice_batch(*args, anchors=[t_anchor])[0]
    assert np.isfinite(anchored.objective)
    anchored.partition.validate(task("torch"))
    with pytest.raises(ValueError, match="align"):
        t_lat.solve_lattice_batch(*args, anchors=[t_anchor, t_anchor])
