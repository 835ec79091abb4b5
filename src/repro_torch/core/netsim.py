"""Flow-level NoP network simulator — reproduces the paper's Fig. 3
motivation study (done there with ASTRA-sim). The port's copy of the
JAX package's ``core/netsim.py``, plain numpy, unchanged in behaviour.

Model: a 2-D mesh of chiplets with dimension-ordered (row-first) XY
routing, plus a memory node attached to one or more chiplets through its
memory-interface link (capacity = memory bandwidth). All chiplets
concurrently pull a fixed message from memory; flows share links by
max-min fair allocation, advanced event-by-event until completion.

Two engines share the :mod:`.topology` link graph:

  * ``engine="event"`` — the original per-flow progressive-filling loop
    over dict-keyed links; the behavioral reference.
  * ``engine="vectorized"`` (default) — flows become one dense
    ``[n_flows, n_links]`` route-incidence matrix and each event step
    solves the max-min waterfilling fixed point with array ops
    (:func:`waterfill_rates` / :func:`simulate_flows`). Completion times
    match the event engine to float64 round-off; the same program,
    batched over whole (mesh × memory × placement × bandwidth) grids,
    runs on the card in :mod:`.netsim_torch` (one launch of the
    hand-written waterfilling kernel).

This reproduces the paper's three observations:
  * DRAM (low BW): the memory link is the bottleneck — doubling NoP
    bandwidth yields no improvement (Fig. 3a/d).
  * HBM (high BW): congestion moves onto the mesh links near the
    attachment point — latency scales linearly with NoP BW (Fig. 3b/d).
  * Central placement balances the mesh load (12 flows on the hottest
    corner link vs 8 centrally) — ≈1.5× over peripheral for HBM
    (paper: 1.53×, Fig. 3c/d).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .topology import MeshGraph

__all__ = [
    "MeshNet",
    "simulate_pull",
    "simulate_flows",
    "waterfill_rates",
    "fig3_case",
    "fig3_net",
]

GB = 1e9

#: A flow is "finished" below this many bytes (absolute, matches the
#: historical event-driven threshold).
EPS_BYTES = 1e-6

#: Event-loop iteration guard — the simulation must converge long before.
MAX_EVENTS = 10000

ENGINES = ("vectorized", "event")


@dataclasses.dataclass
class Flow:
    dst: int
    bytes_left: float
    route: list[tuple[int, int]]   # list of directed link keys
    done_at: float | None = None


class MeshNet:
    """X×Y mesh + memory node (id = X*Y) attached to ``attach`` chiplets.

    Geometry (link enumeration, XY routing) comes from
    :class:`.topology.MeshGraph`; this class binds capacities
    and the attachment set to it. ``cap`` keeps the historical dict form
    (mesh links + the attach ports only) for the event engine and the
    utilization reports; the vectorized engine reads the dense
    ``link_caps`` array over the full batchable link space.
    """

    def __init__(self, X: int, Y: int, bw_nop, bw_mem: float,
                 attach: list[int], mem_scale=None):
        self.X, self.Y = X, Y
        self.graph = MeshGraph(X, Y)
        self.mem = self.graph.mem
        self.attach = attach
        # ``bw_nop`` may be per-chiplet (``[X, Y]`` or ``[X·Y]``) for
        # heterogeneous grids; a mesh link runs at the min of its
        # endpoint rates. Scalars keep the historical float attribute.
        b = np.asarray(bw_nop, dtype=np.float64)
        self.bw_nop = float(b) if b.ndim == 0 else b.reshape(-1)
        self.bw_mem = float(bw_mem)
        self.mem_scale = (None if mem_scale is None
                          else np.asarray(mem_scale,
                                          dtype=np.float64).reshape(-1))
        per_node = (np.full(X * Y, float(bw_nop)) if b.ndim == 0
                    else b.reshape(-1))
        self.cap: dict[tuple[int, int], float] = {}
        for (u, v) in self.graph.links[: self.graph.n_mesh_links_directed]:
            self.cap[(u, v)] = min(per_node[u], per_node[v])
        # memory interface link(s): capacity = memory BW split across ports
        for a in attach:
            share = bw_mem / len(attach)
            if self.mem_scale is not None:
                share = share * self.mem_scale[a]
            self.cap[(self.mem, a)] = share
            self.cap[(a, self.mem)] = share

    def node_rc(self, n: int) -> tuple[int, int]:
        return divmod(n, self.Y)

    def route(self, src: int, dst: int) -> list[tuple[int, int]]:
        """Memory → nearest attach chiplet → XY (row-dimension-first)."""
        if src == self.mem:
            return self.graph.pull_route(self.attach, dst)
        return self.graph.xy_route(src, dst)

    # ------------------------------------------------------- dense views
    def link_caps(self) -> np.ndarray:
        """Capacities over the full :class:`MeshGraph` link space [L]."""
        return self.graph.link_caps(self.bw_nop, self.bw_mem, self.attach,
                                    mem_scale=self.mem_scale)

    def pull_incidence(self) -> np.ndarray:
        """[n_flows, n_links] incidence of the all-chiplets-pull flows."""
        return self.graph.pull_incidence(self.attach)


def _maxmin_rates(flows: list[Flow], cap: dict) -> dict[int, float]:
    """Classic progressive-filling max-min fair allocation (event-engine
    reference; :func:`waterfill_rates` is the array-program equivalent).

    A flow is live while it holds more than ``EPS_BYTES`` — the same
    threshold the event loop uses to retire flows, so a float residue in
    (0, EPS] can never linger as a phantom link user."""
    active = {i for i, f in enumerate(flows) if f.bytes_left > EPS_BYTES}
    residual = dict(cap)
    on_link: dict[tuple[int, int], set[int]] = {}
    for i in active:
        for l in flows[i].route:
            on_link.setdefault(l, set()).add(i)
    rates: dict[int, float] = {}
    unfixed = set(active)
    while unfixed:
        best_share, best_link = None, None
        for l, users in on_link.items():
            live = users & unfixed
            if not live:
                continue
            share = residual[l] / len(live)
            if best_share is None or share < best_share:
                best_share, best_link = share, l
        if best_link is None:
            for i in unfixed:
                rates[i] = float("inf")
            break
        for i in on_link[best_link] & set(unfixed):
            rates[i] = best_share
            unfixed.discard(i)
            for l in flows[i].route:
                residual[l] -= best_share
        residual = {l: max(0.0, v) for l, v in residual.items()}
    return rates


# ----------------------------------------------------- vectorized engine
def waterfill_rates(inc: np.ndarray, cap: np.ndarray,
                    active: np.ndarray) -> np.ndarray:
    """Max-min fair rates by progressive filling, as array ops.

    ``inc`` is the ``[F, L]`` route-incidence matrix, ``cap`` the ``[L]``
    capacities, ``active`` a ``[F]`` bool mask. Each iteration finds the
    bottleneck link (minimum residual fair share), fixes its flows at
    that share, and subtracts; at least one link retires per iteration,
    so the fixed point lands in ≤L steps. Mirrors the event engine's
    :func:`_maxmin_rates` (the max-min allocation is unique, so the two
    agree to float64 round-off)."""
    F, L = inc.shape
    residual = cap.astype(np.float64).copy()
    unfixed = active.astype(bool).copy()
    rates = np.zeros(F, dtype=np.float64)
    for _ in range(L + 1):
        users = unfixed.astype(np.float64) @ inc          # [L]
        live = users > 0
        if not live.any():
            break
        share = np.where(live, residual / np.where(live, users, 1.0),
                         np.inf)
        l = int(np.argmin(share))
        s = share[l]
        newly = unfixed & (inc[:, l] > 0)
        rates[newly] = s
        residual = np.maximum(
            residual - (newly.astype(np.float64) @ inc) * s, 0.0)
        unfixed &= ~newly
    return rates


def simulate_flows(inc: np.ndarray, cap: np.ndarray,
                   message_bytes: np.ndarray) -> dict[str, np.ndarray]:
    """Vectorized event-driven simulation of ``F`` concurrent flows.

    Each event step solves the waterfilling fixed point, advances to the
    next flow completion, and retires finished flows. Returns
    ``latency`` (scalar), per-flow ``done`` times ``[F]`` and per-link
    ``link_bytes`` ``[L]``. This is the numpy reference for the batched
    :mod:`.netsim_torch` engine — both must agree to float64 round-off.
    """
    bytes_left = np.asarray(message_bytes, dtype=np.float64).copy()
    F, L = inc.shape
    t = 0.0
    done = np.zeros(F, dtype=np.float64)
    link_bytes = np.zeros(L, dtype=np.float64)
    guard = 0
    while (bytes_left > EPS_BYTES).any():
        guard += 1
        if guard > MAX_EVENTS:
            raise RuntimeError("simulation did not converge")
        active = bytes_left > EPS_BYTES
        rates = waterfill_rates(inc, cap, active)
        pos = active & (rates > 0)
        if not pos.any():
            raise RuntimeError("simulation stalled (zero rates)")
        dt = float(np.min(np.where(
            pos, bytes_left / np.where(pos, rates, 1.0), np.inf)))
        moved = np.where(active, rates * dt, 0.0)
        link_bytes += np.minimum(moved, bytes_left) @ inc
        bytes_left = np.maximum(bytes_left - moved, 0.0)
        newly = active & (bytes_left <= EPS_BYTES)
        done = np.where(newly, t + dt, done)
        t += dt
    return {"latency": t, "done": done, "link_bytes": link_bytes}


def simulate_pull(net: MeshNet, message_bytes: float,
                  engine: str = "vectorized") -> dict[str, object]:
    """All chiplets pull ``message_bytes`` from memory concurrently."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
    if engine == "vectorized":
        return _simulate_pull_vec(net, message_bytes)
    return _simulate_pull_event(net, message_bytes)


def _simulate_pull_vec(net: MeshNet, message_bytes: float
                       ) -> dict[str, object]:
    inc = net.pull_incidence()
    caps = net.link_caps()
    F = net.X * net.Y
    out = simulate_flows(inc, caps, np.full(F, float(message_bytes)))
    t = out["latency"]
    idx = net.graph.index
    link_bytes = {l: float(out["link_bytes"][idx[l]]) for l in net.cap}
    util = {l: b / (net.cap[l] * t) if t > 0 else 0.0
            for l, b in link_bytes.items()}
    flows = []
    for d in range(F):
        f = Flow(d, 0.0, net.route(net.mem, d))
        f.done_at = float(out["done"][d])
        flows.append(f)
    return {"latency": t, "link_bytes": link_bytes, "link_util": util,
            "flows": flows, "done": out["done"]}


def _simulate_pull_event(net: MeshNet, message_bytes: float
                         ) -> dict[str, object]:
    flows = [Flow(d, message_bytes, net.route(net.mem, d))
             for d in range(net.X * net.Y)]
    t = 0.0
    link_bytes: dict[tuple[int, int], float] = {l: 0.0 for l in net.cap}
    guard = 0
    while any(f.bytes_left > EPS_BYTES for f in flows):
        guard += 1
        if guard > MAX_EVENTS:
            raise RuntimeError("simulation did not converge")
        rates = _maxmin_rates(flows, net.cap)
        # time to next completion
        dt = min(f.bytes_left / rates[i] for i, f in enumerate(flows)
                 if f.bytes_left > EPS_BYTES and rates.get(i, 0) > 0)
        for i, f in enumerate(flows):
            if f.bytes_left > EPS_BYTES:
                moved = rates[i] * dt
                for l in f.route:
                    link_bytes[l] += min(moved, f.bytes_left)
                f.bytes_left = max(0.0, f.bytes_left - moved)
                if f.bytes_left <= EPS_BYTES and f.done_at is None:
                    f.done_at = t + dt
        t += dt
    util = {l: b / (net.cap[l] * t) if t > 0 else 0.0
            for l, b in link_bytes.items()}
    return {"latency": t, "link_bytes": link_bytes, "link_util": util,
            "flows": flows,
            "done": np.array([f.done_at or 0.0 for f in flows])}


def fig3_net(memory: str = "hbm", placement: str = "peripheral",
             bw_nop: float = 60 * GB, X: int = 4, Y: int = 4) -> MeshNet:
    """The mesh of one Fig. 3 cell (DRAM 60 GB/s / HBM 1024 GB/s;
    peripheral = corner attach, central = interior attach)."""
    bw_mem = 1024 * GB if memory.lower() == "hbm" else 60 * GB
    if placement == "peripheral":
        attach = [0]
    elif placement == "central":
        attach = [1 * Y + 1]
    else:
        raise ValueError(placement)
    return MeshNet(X, Y, bw_nop, bw_mem, attach)


def fig3_case(memory: str = "hbm", placement: str = "peripheral",
              bw_nop: float = 60 * GB, message: float = 1 * GB,
              X: int = 4, Y: int = 4,
              engine: str = "vectorized") -> dict[str, object]:
    """One cell of the paper's Fig. 3 study (4×4 mesh, 1 GB pulls,
    DRAM 60 GB/s / HBM 1024 GB/s)."""
    net = fig3_net(memory, placement, bw_nop, X, Y)
    out = simulate_pull(net, message, engine=engine)
    out["memory"] = memory
    out["placement"] = placement
    out["bw_nop"] = bw_nop
    return out
