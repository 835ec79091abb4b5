"""The port's flow netsim (``repro_torch.core.topology.MeshGraph``,
``hw.Topology.flow_net``, ``core/netsim.py``, ``core/netsim_torch.py``
and ``sweep.netsim_sweep``) against the JAX package's, from the same
numbers. The JAX package runs on its numpy engines (its JAX netsim needs
``jax.experimental.enable_x64``, which jax 0.9 lacks: ROADMAP.md), which
its own suite holds its JAX engine to (``tests/test_core_netsim.py``).

Contracts: the link graph and the flow network equal JAX's element for
element; the port's numpy netsim equals JAX's at rtol 1e-12 on both
engines; the batched torch engine on the CPU (the waterfilling kernel's
plain version) equals JAX's numpy ``simulate_flows`` at rtol 1e-9
(``link_bytes`` also atol 1e-3), keeps the max-min invariants and
reports NaN where the numpy engine raises; ``netsim_sweep`` caches per
backend and agrees with JAX's numpy sweep. All meshes are 8x8 or
smaller, random demand 4x4 or smaller."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import hw as j_hw
from repro.core import netsim as j_netsim
from repro.core import sweep as j_sweep
from repro.core import topology as j_topo
from repro_torch.core import hw as t_hw
from repro_torch.core import netsim as t_netsim
from repro_torch.core import netsim_torch
from repro_torch.core import sweep as t_sweep
from repro_torch.core import topology as t_topo
from repro_torch.kernels.netsim import kernel as nk
from repro_torch.kernels.netsim import ops as nops
from repro_torch.kernels.netsim.ref import MAX_EVENTS, waterfill_ref

GB = 1e9
FIG3_CELLS = [(m, p, bw * GB) for m in ("dram", "hbm")
              for p in ("peripheral", "central") for bw in (60, 120)]
MESHES = [(1, 1), (2, 3), (4, 4), (8, 8)]


@pytest.fixture(autouse=True)
def _fresh_cache():
    t_sweep.clear_cache()
    j_sweep.clear_cache()
    yield
    t_sweep.clear_cache()
    j_sweep.clear_cache()


# ------------------------------------------------------------ link graph
@pytest.mark.parametrize("X,Y", MESHES, ids=[f"{x}x{y}" for x, y in MESHES])
def test_mesh_graph_equals_jax(X, Y):
    jg, tg = j_topo.MeshGraph(X, Y), t_topo.MeshGraph(X, Y)
    assert tg.links == jg.links and tg.index == jg.index
    assert (tg.n_links, tg.n_mesh_links_directed, tg.mem) == \
        (jg.n_links, jg.n_mesh_links_directed, jg.mem)
    np.testing.assert_array_equal(tg.mesh_link_mask(), jg.mesh_link_mask())
    rng = np.random.default_rng(X * 10 + Y)
    attach = sorted(rng.choice(X * Y, size=min(3, X * Y),
                               replace=False).tolist())
    assign = rng.choice(attach, size=X * Y)
    for d in range(X * Y):
        assert t_topo.nearest_attach(attach, d, Y) == \
            j_topo.nearest_attach(attach, d, Y)
        assert tg.pull_route(attach, d) == jg.pull_route(attach, d)
        assert tg.push_route(attach, d) == jg.push_route(attach, d)
        assert tg.xy_route(d, attach[0]) == jg.xy_route(d, attach[0])
    for a in (None, assign):
        np.testing.assert_array_equal(tg.pull_incidence(attach, a),
                                      jg.pull_incidence(attach, a))
        np.testing.assert_array_equal(tg.push_incidence(attach, a),
                                      jg.push_incidence(attach, a))
    bw_nop = rng.uniform(30, 120, X * Y) * GB
    mem_scale = rng.uniform(0.5, 1.5, X * Y)
    for args, kw in (((60 * GB, 1000 * GB, attach), {}),
                     ((bw_nop, 1000 * GB, attach), {}),
                     ((bw_nop, 60 * GB, attach), {"mem_scale": mem_scale})):
        got, want = tg.link_caps(*args, **kw), jg.link_caps(*args, **kw)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def _hetero(pkg, t):
    hw = pkg.make_hw(t, 4, "hbm")
    fast = pkg.ChipletClass("fast", freq_hz=1.5e9, bw_nop=120e9)
    slow = pkg.ChipletClass("slow", freq_hz=0.5e9, bw_nop=30e9,
                            mem_scale=0.5)
    return dataclasses.replace(hw, chiplet_classes=(fast, slow),
                               class_assignment=(0,) * 8 + (1,) * 8)


FLOW_NETS = ([(t, g, diag, False) for t in "ABCD" for g in (2, 4)
              for diag in (False, True)]
             + [(t, 4, False, True) for t in "AB"])


@pytest.mark.parametrize("t,g,diag,hetero", FLOW_NETS,
                         ids=[f"{t}{g}{'d' if d else ''}{'h' if h else ''}"
                              for t, g, d, h in FLOW_NETS])
def test_flow_net_equals_jax_bytewise(t, g, diag, hetero):
    if hetero:
        jh, th = _hetero(j_hw, t), _hetero(t_hw, t)
    else:
        jh = j_hw.make_hw(t, g, "hbm", diagonal_links=diag)
        th = t_hw.make_hw(t, g, "hbm", diagonal_links=diag)
    assert th.topology.mesh_graph == t_topo.MeshGraph(g if not hetero else 4,
                                                      g if not hetero else 4)
    got, want = th.topology.flow_net(), jh.topology.flow_net()
    assert th.topology.flow_net() is got          # cached per topology
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


# ------------------------------------------------------- numpy netsim
def _random_case(pkg, seed: int):
    """``tests/test_core_netsim.py``'s random mesh, in either package."""
    rng = np.random.default_rng(seed)
    X, Y = int(rng.integers(1, 5)), int(rng.integers(1, 5))
    k = int(rng.integers(1, X * Y + 1))
    attach = sorted(rng.choice(X * Y, size=k, replace=False).tolist())
    net = pkg.MeshNet(X, Y, float(rng.uniform(20, 200)) * GB,
                      float(rng.uniform(20, 2000)) * GB, attach)
    msgs = rng.uniform(0.01, 1.0, X * Y) * GB
    return net, msgs


@pytest.mark.parametrize("engine", j_netsim.ENGINES)
@pytest.mark.parametrize("mem,placement,bw", FIG3_CELLS)
def test_fig3_case_equals_jax(mem, placement, bw, engine):
    a = j_netsim.fig3_case(mem, placement, bw, engine=engine)
    b = t_netsim.fig3_case(mem, placement, bw, engine=engine)
    assert b["latency"] == pytest.approx(a["latency"], rel=1e-12)
    np.testing.assert_allclose(b["done"], a["done"], rtol=1e-12)
    assert b["link_bytes"].keys() == a["link_bytes"].keys()
    for link, v in a["link_bytes"].items():
        assert b["link_bytes"][link] == pytest.approx(v, rel=1e-12,
                                                       abs=1e-6)
        assert b["link_util"][link] == pytest.approx(
            a["link_util"][link], rel=1e-12, abs=1e-15)
    assert [f.route for f in b["flows"]] == [f.route for f in a["flows"]]


@pytest.mark.parametrize("seed", range(8))
def test_random_mesh_equals_jax(seed):
    jn, msgs = _random_case(j_netsim, seed)
    tn, _ = _random_case(t_netsim, seed)
    inc, cap = tn.pull_incidence(), tn.link_caps()
    np.testing.assert_array_equal(inc, jn.pull_incidence())
    np.testing.assert_array_equal(cap, jn.link_caps())
    assert tn.cap == jn.cap
    active = msgs > 0
    np.testing.assert_allclose(t_netsim.waterfill_rates(inc, cap, active),
                               j_netsim.waterfill_rates(inc, cap, active),
                               rtol=1e-12)
    a = j_netsim.simulate_flows(inc, cap, msgs)
    b = t_netsim.simulate_flows(inc, cap, msgs)
    assert b["latency"] == pytest.approx(a["latency"], rel=1e-12)
    np.testing.assert_allclose(b["done"], a["done"], rtol=1e-12)
    np.testing.assert_allclose(b["link_bytes"], a["link_bytes"], rtol=1e-12)
    assert (t_netsim.EPS_BYTES, t_netsim.MAX_EVENTS) == \
        (j_netsim.EPS_BYTES, j_netsim.MAX_EVENTS) == (1e-6, MAX_EVENTS)


def test_numpy_engine_raises_where_torch_reports_nan():
    net, msgs = _random_case(t_netsim, 3)
    cap = net.link_caps()
    cap[net.graph.index[(net.mem, net.attach[0])]] = 0.0   # a dead port
    inc = net.pull_incidence()
    with pytest.raises(RuntimeError, match="stalled"):
        j_netsim.simulate_flows(inc, cap, msgs)
    with pytest.raises(RuntimeError, match="stalled"):
        t_netsim.simulate_flows(inc, cap, msgs)
    out = netsim_torch.simulate_pull_batch(cap[None], inc[None],
                                           msgs[None], device="cpu")
    assert all(np.isnan(v).all() for v in out.values())
    # A healthy simulation beside it in the batch is untouched.
    good = net.link_caps()
    both = netsim_torch.simulate_pull_batch(
        np.stack([cap, good]), np.stack([inc, inc]), np.stack([msgs, msgs]),
        device="cpu")
    assert np.isnan(both["latency"][0])
    ref = j_netsim.simulate_flows(inc, good, msgs)
    assert both["latency"][1] == ref["latency"]


# ------------------------------------------------- batched torch engine
def _check_invariants(jnet, msgs):
    """``tests/test_core_netsim.py``'s max-min invariants, on the port's
    torch rates; completion times against JAX's numpy engine."""
    inc, cap = jnet.pull_incidence(), jnet.link_caps()
    active = msgs > 0
    rates = netsim_torch.waterfill_rates(
        torch.from_numpy(inc), torch.from_numpy(cap),
        torch.from_numpy(active)).numpy()
    np.testing.assert_allclose(
        rates, j_netsim.waterfill_rates(inc, cap, active), rtol=1e-9)
    load = (rates * active) @ inc
    assert (load <= cap * (1 + 1e-9)).all()
    saturated = load >= cap * (1 - 1e-9)
    for f in np.where(active)[0]:
        assert (inc[f] * saturated).any(), f"flow {f} not bottlenecked"
    ref = j_netsim.simulate_flows(inc, cap, msgs)
    out = netsim_torch.simulate_pull_batch(cap[None], inc[None],
                                           msgs[None], device="cpu")
    np.testing.assert_allclose(out["latency"][0], ref["latency"], rtol=1e-9)
    np.testing.assert_allclose(out["done"][0], ref["done"], rtol=1e-9)
    np.testing.assert_allclose(out["link_bytes"][0], ref["link_bytes"],
                               rtol=1e-9, atol=1e-3)
    np.testing.assert_allclose(out["link_bytes"][0], msgs @ inc, rtol=1e-9,
                               atol=1e-3)
    t, done, lb = netsim_torch.waterfill_times(
        torch.from_numpy(cap), torch.from_numpy(inc), torch.from_numpy(msgs))
    assert float(t) == out["latency"][0]
    np.testing.assert_array_equal(done.numpy(), out["done"][0])


@pytest.mark.parametrize("seed", range(8))
def test_torch_engine_invariants_random_meshes(seed):
    _check_invariants(*_random_case(j_netsim, seed))


def test_torch_batch_matches_numpy_on_fig3_grid():
    """One batched call over the whole Fig. 3 grid == per-cell numpy."""
    nets = [j_netsim.fig3_net(m, p, bw) for m, p, bw in FIG3_CELLS]
    caps = np.stack([n.link_caps() for n in nets])
    incs = np.stack([n.pull_incidence() for n in nets])
    msgs = np.full((len(nets), 16), 1 * GB)
    out = netsim_torch.simulate_pull_batch(caps, incs, msgs, device="cpu")
    for g, net in enumerate(nets):
        ref = j_netsim.simulate_flows(net.pull_incidence(), net.link_caps(),
                                      msgs[g])
        np.testing.assert_allclose(out["latency"][g], ref["latency"],
                                   rtol=1e-9)
        np.testing.assert_allclose(out["done"][g], ref["done"], rtol=1e-9)
        np.testing.assert_allclose(out["link_bytes"][g], ref["link_bytes"],
                                   rtol=1e-9, atol=1e-3)


def test_plain_version_shared_routes_and_edge_cases():
    """``N`` networks × ``S`` simulations: a network shared by its
    simulations equals each one run alone; all-zero demand finishes at
    0; a single flow runs at its route's least capacity."""
    net, _ = _random_case(j_netsim, 5)
    inc, cap = net.pull_incidence(), net.link_caps()
    F = inc.shape[0]
    rng = np.random.default_rng(0)
    msgs = rng.uniform(0.01, 1.0, (3, F)) * GB
    msgs[1] = 0.0
    msgs[2] = 0.0
    msgs[2, F - 1] = 1 * GB
    shared = waterfill_ref(torch.from_numpy(cap[None]),
                           torch.from_numpy(inc[None]),
                           torch.from_numpy(msgs[None]))
    for s in range(3):
        alone = waterfill_ref(torch.from_numpy(cap[None]),
                              torch.from_numpy(inc[None]),
                              torch.from_numpy(msgs[None, s:s + 1]))
        for a, b in zip(shared, alone):
            assert torch.equal(a[:, s:s + 1], b)
    lat, done, lb, rounds = shared
    assert float(lat[0, 1]) == 0.0 and int(rounds[0, 1]) == 0
    assert not done[0, 1].any() and not lb[0, 1].any()
    route = inc[F - 1] > 0
    assert float(lat[0, 2]) == pytest.approx(GB / cap[route].min(),
                                             rel=1e-12)
    assert float(lat[0, 0]) == j_netsim.simulate_flows(inc, cap,
                                                       msgs[0])["latency"]


def test_route_lists_round_trip():
    net, _ = _random_case(j_netsim, 6)
    inc = np.stack([net.pull_incidence(), net.graph.push_incidence(
        net.attach)])
    routes = nops.route_lists(inc)
    assert routes.dtype == np.int32
    assert routes.shape[-1] == int(inc.sum(-1).max())
    back = np.zeros_like(inc)
    for idx in np.ndindex(routes.shape[:-1]):
        r = routes[idx]
        on = r[r >= 0]
        assert (np.diff(on) > 0).all() and (r[len(on):] == -1).all()
        back[idx][on] = 1.0
    np.testing.assert_array_equal(back, inc)
    assert nops.route_lists(inc, 9).shape[-1] == 9
    with pytest.raises(ValueError, match="does not fit"):
        nops.route_lists(inc, 1)


def test_kernel_wrapper_refuses_what_it_cannot_take():
    """The wrapper's checks run before anything is built: CPU tensors,
    a wrong dtype and more flows than a block has threads are refused."""
    cap = torch.ones(1, 4, dtype=torch.float64)
    routes = torch.zeros(1, 2, 1, dtype=torch.int32)
    msgs = torch.ones(1, 1, 2, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        nk.waterfill(cap, routes, msgs)
    with pytest.raises(ValueError, match="CUDA tensors"):
        nk.waterfill(cap.float(), routes, msgs)
    assert nk.threads(1) == 32 and nk.threads(33) == 64
    assert nk.threads(256) == 256 and nk.smem_bytes(256, 1472, 31) < \
        nk.MAX_SMEM


# ------------------------------------------------------------ netsim_sweep
def test_netsim_sweep_cache_and_backends_match_jax():
    nets_j = [j_netsim.fig3_net(m, p, bw) for m, p, bw in FIG3_CELLS]
    nets_t = [t_netsim.fig3_net(m, p, bw) for m, p, bw in FIG3_CELLS]
    want = j_sweep.netsim_sweep(nets_j, 1 * GB, backend="numpy")
    a = t_sweep.netsim_sweep(nets_t, 1 * GB, backend="torch", device="cpu")
    assert t_sweep.cache_stats() == {"hits": 0, "misses": len(nets_t)}
    b = t_sweep.netsim_sweep(nets_t, 1 * GB, backend="torch", device="cpu")
    assert t_sweep.cache_stats()["hits"] == len(nets_t)
    c = t_sweep.netsim_sweep(nets_t, 1 * GB, backend="numpy")
    assert t_sweep.cache_stats()["misses"] == 2 * len(nets_t)
    for w, ra, rb, rc in zip(want, a, b, c):
        assert ra["latency"] == rb["latency"]
        assert rc["latency"] == pytest.approx(w["latency"], rel=1e-12)
        np.testing.assert_allclose(rc["done"], w["done"], rtol=1e-12)
        np.testing.assert_allclose(rc["link_bytes"], w["link_bytes"],
                                   rtol=1e-12)
        assert ra["latency"] == pytest.approx(w["latency"], rel=1e-9)
        np.testing.assert_allclose(ra["done"], w["done"], rtol=1e-9)
        np.testing.assert_allclose(ra["link_bytes"], w["link_bytes"],
                                   rtol=1e-9, atol=1e-3)
    # Fig. 3's headline claims (tests/test_core_netsim.py).
    lat = {cell: r["latency"] for cell, r in zip(FIG3_CELLS, a)}
    hbm_p60, hbm_p120 = lat[("hbm", "peripheral", 60 * GB)], \
        lat[("hbm", "peripheral", 120 * GB)]
    assert hbm_p60 / hbm_p120 == pytest.approx(2.0, rel=1e-3)
    assert lat[("dram", "peripheral", 60 * GB)] == pytest.approx(
        lat[("dram", "peripheral", 120 * GB)], rel=1e-6)
    assert hbm_p60 / lat[("hbm", "central", 60 * GB)] == pytest.approx(
        1.5, abs=0.1)
    # Records carry the backend (and torch device type) in their keys.
    keys = {k[1] for k in t_sweep.export_cache()}
    assert keys == {("torch", "cpu"), "numpy"}


def test_netsim_sweep_groups_shapes_and_checkpoints(tmp_path):
    nets = [t_netsim.MeshNet(2, 3, 60 * GB, 1000 * GB, [0]),
            t_netsim.fig3_net("hbm", "central"),
            t_netsim.MeshNet(2, 3, 90 * GB, 60 * GB, [1, 4])]
    recs = t_sweep.netsim_sweep(nets, 0.5 * GB, backend="torch",
                                device="cpu", checkpoint=tmp_path / "n.bin",
                                checkpoint_every=2)
    for net, rec in zip(nets, recs):
        ref = j_netsim.simulate_flows(net.pull_incidence(), net.link_caps(),
                                      np.full(net.X * net.Y, 0.5 * GB))
        assert rec["latency"] == pytest.approx(ref["latency"], rel=1e-9)
        assert rec["link_bytes"].shape == (net.graph.n_links,)
    t_sweep.clear_cache()
    again = t_sweep.netsim_sweep(nets, 0.5 * GB, backend="torch",
                                 device="cpu", checkpoint=tmp_path / "n.bin")
    assert t_sweep.cache_stats() == {"hits": 3, "misses": 0}
    assert [r["latency"] for r in again] == [r["latency"] for r in recs]


def test_netsim_narrowings_and_validation():
    """``devices="sharded"`` is no narrowing any more: it equals the
    single-device records bit for bit; bad modes and backends raise."""
    nets = [t_netsim.fig3_net()]
    single = t_sweep.netsim_sweep(nets, GB, devices="single", device="cpu",
                                  cache=False)
    sharded = t_sweep.netsim_sweep(nets, GB, devices="sharded",
                                   device="cpu", cache=False)
    assert single[0]["latency"] == sharded[0]["latency"]
    np.testing.assert_array_equal(single[0]["done"], sharded[0]["done"])
    args = (np.ones((1, 4)), np.ones((1, 1, 4)), np.ones((1, 1)))
    a = netsim_torch.simulate_pull_batch(*args, device="cpu")
    b = netsim_torch.simulate_pull_batch(*args, device="cpu",
                                         devices="sharded")
    assert a["latency"][0] == b["latency"][0]
    with pytest.raises(ValueError, match="devices"):
        t_sweep.netsim_sweep(nets, GB, devices="tpu", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        t_sweep.netsim_sweep(nets, GB, backend="jax")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_sweep.netsim_sweep(nets, GB)
