"""Shared MCM topology layer: the single source of truth for mesh
geometry (the port's copy of the JAX package's ``core/topology.py``, plain
numpy, unchanged in behaviour).

Everything here is an array-valued primitive:

  * **Entrance geometry** — :func:`entrances` (packaging types A–D,
    Fig. 2/4), :func:`assign_entrances` (nearest-entrance chiplet
    grouping + the Sec. 4.2.1 local indices), :func:`entrance_masks`
    (the per-entrance one-hot / row / column masks the evaluator's
    off-chip serialization terms consume).
  * **Hop matrices** — :func:`hop_matrices` (eqs. 10–12 plus the
    Sec. 5.1.1 diagonal-link alternative) and :func:`n_mesh_links`
    (entrance link counts for the eq. 8 collection bandwidth).
  * **Link graph** — :class:`MeshGraph` (directed links, XY routing,
    route incidence matrices, per-link capacities) and
    :func:`nearest_attach`, the flow netsim's network
    (:mod:`.netsim`, :mod:`.netsim_torch`) and the evaluator's
    ``congestion="flow"`` mode.

Every chiplet gets a memory-port link pair (``mem → c`` and ``c →
mem``) whether or not memory attaches there. Unused ports carry no
flows, so they never constrain the waterfilling, and the link axis stays
a pure function of (X, Y): whole (memory × placement × bandwidth) grids
share one array shape and batch through one netsim call.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

__all__ = [
    "entrances",
    "n_mesh_links",
    "assign_entrances",
    "hop_matrices",
    "entrance_masks",
    "nearest_attach",
    "MeshGraph",
]


# ------------------------------------------------------------- entrances
def entrances(mcm_type, X: int, Y: int) -> list[tuple[int, int, str]]:
    """Memory entrance chiplets as (gx, gy, kind), kind in
    {"corner", "edge", "3d"} — packaging types A–D of Fig. 2/4."""
    t = getattr(mcm_type, "value", mcm_type)
    if t == "A":
        return [(0, 0, "corner")]
    if t == "B":
        # Memory stacks on left and right edges, one per row per side.
        out = []
        for gx in range(X):
            out.append((gx, 0, "edge"))
            if Y > 1:
                out.append((gx, Y - 1, "edge"))
        return out
    if t == "C":
        return [(gx, gy, "3d") for gx in range(X) for gy in range(Y)]
    if t == "D":
        # Type B edges + 3D stacks on the interior quad.
        out = []
        for gx in range(X):
            out.append((gx, 0, "edge"))
            if Y > 1:
                out.append((gx, Y - 1, "edge"))
        x0, x1 = (X - 1) // 2, X // 2
        y0, y1 = (Y - 1) // 2, Y // 2
        for gx in sorted({x0, x1}):
            for gy in sorted({y0, y1}):
                if 0 < gy < Y - 1 or Y <= 2:
                    out.append((gx, gy, "3d"))
        return out
    raise ValueError(f"unknown MCM type {t}")


def n_mesh_links(gx: int, gy: int, X: int, Y: int, diagonal: bool) -> int:
    """Number of NoP links incident to chiplet (gx, gy) in an X×Y mesh.

    Diagonal links (Sec. 5.1) add one diagonal neighbour toward the grid
    interior — a corner global chiplet goes from 2 to 3 entrance links,
    the paper's "50% more bandwidth on the bottleneck communication".
    """
    n = 0
    n += 1 if gx > 0 else 0
    n += 1 if gx < X - 1 else 0
    n += 1 if gy > 0 else 0
    n += 1 if gy < Y - 1 else 0
    if diagonal:
        # One diagonal link per chiplet toward the interior diagonal mate.
        if (gx < X - 1 and gy < Y - 1) or (gx > 0 and gy > 0):
            n += 1
    return n


def assign_entrances(X: int, Y: int, ents: list[tuple[int, int, str]]):
    """Group chiplets by nearest entrance (manhattan, ties broken by
    entrance order). Returns ``(entrance_id, x_local, y_local, Xg, Yg)``,
    all ``[X, Y]`` int arrays — the Sec. 4.2.1 local indexing."""
    gx = np.arange(X)[:, None] * np.ones((1, Y), dtype=int)
    gy = np.ones((X, 1), dtype=int) * np.arange(Y)[None, :]
    dists = np.stack(
        [np.abs(gx - ex) + np.abs(gy - ey) for ex, ey, _ in ents], axis=0)
    entrance_id = np.argmin(dists, axis=0)                    # [X, Y]
    ex = np.array([e[0] for e in ents])
    ey = np.array([e[1] for e in ents])
    x_local = np.abs(gx - ex[entrance_id])
    y_local = np.abs(gy - ey[entrance_id])
    Xg = np.ones((X, Y), dtype=int)
    Yg = np.ones((X, Y), dtype=int)
    for e in range(len(ents)):
        m = entrance_id == e
        if m.any():
            Xg[m] = int(x_local[m].max()) + 1
            Yg[m] = int(y_local[m].max()) + 1
    return entrance_id, x_local, y_local, Xg, Yg


def hop_matrices(x_local, y_local, Xg, Yg, diagonal: bool):
    """The Sec. 4.3 hop-count matrices (eqs. 10–12).

    Returns ``(hops_low, hops_row_shared, hops_col_shared)``:
      * eq. 10 (low off-chip BW): minimal path ``x + y``;
      * eq. 11 (high BW, row-shared): ``X + y`` with farthest-first
        waiting;
      * eq. 12 (high BW, col-shared): ``Y + x``;
      * Sec. 5.1.1 diagonal alternative ``X − x + max(x, y)`` taken as a
        per-chiplet min (the two strategies use disjoint links).

    3D zero-hop masking (a chiplet directly under its memory stack) is
    the caller's job — it needs entrance *kind*, which is not a hop fact.
    """
    x, y = x_local, y_local
    hops_low = x + y
    h_row = Xg + y
    h_col = Yg + x
    if diagonal:
        h_row = np.minimum(h_row, Xg - x + np.maximum(x, y))
        h_col = np.minimum(h_col, Yg - y + np.maximum(x, y))
    return hops_low, h_row, h_col


def entrance_masks(X: int, Y: int, ents, entrance_id):
    """Per-entrance membership masks consumed by the evaluator:
    ``(ent_mask [E,X,Y], ent_pos [E,X,Y], row_mask [E,X], col_mask
    [E,Y])`` — group membership, entrance position one-hots, and their
    row/column projections (off-chip serialization is per entrance over
    the rows/columns its group spans)."""
    E = len(ents)
    ent_mask = np.zeros((E, X, Y), dtype=bool)
    for e in range(E):
        ent_mask[e] = entrance_id == e
    ent_pos = np.zeros((E, X, Y), dtype=bool)
    for i, (exi, eyi, _) in enumerate(ents):
        ent_pos[i, exi, eyi] = True
    return ent_mask, ent_pos, ent_mask.any(axis=2), ent_mask.any(axis=1)


# ------------------------------------------------------------ link graph
def nearest_attach(attach: list[int], dst: int, Y: int) -> int:
    """Attach chiplet closest (manhattan) to ``dst``; ties break by
    ``attach`` order — the netsim's historical routing rule."""
    dr, dc = divmod(dst, Y)
    return min(attach,
               key=lambda a: abs(a // Y - dr) + abs(a % Y - dc))


@dataclasses.dataclass(frozen=True)
class MeshGraph:
    """Directed link enumeration + XY routing for an X×Y mesh with a
    memory node (id ``X*Y``) reachable through per-chiplet ports.

    Link order: all directed mesh links (row-major over chiplets, the
    +x then +y neighbour, both directions), then the ``mem → c`` port of
    every chiplet, then every ``c → mem`` port. The link axis is a pure
    function of (X, Y): ``n_links = 2·(X·(Y−1) + Y·(X−1)) + 2·X·Y``.
    """

    X: int
    Y: int

    @property
    def n_nodes(self) -> int:
        return self.X * self.Y

    @property
    def mem(self) -> int:
        return self.X * self.Y

    @cached_property
    def links(self) -> tuple[tuple[int, int], ...]:
        X, Y, mem = self.X, self.Y, self.mem
        out: list[tuple[int, int]] = []
        for r in range(X):
            for c in range(Y):
                u = r * Y + c
                for (rr, cc) in ((r + 1, c), (r, c + 1)):
                    if rr < X and cc < Y:
                        v = rr * Y + cc
                        out.append((u, v))
                        out.append((v, u))
        out += [(mem, c) for c in range(X * Y)]
        out += [(c, mem) for c in range(X * Y)]
        return tuple(out)

    @cached_property
    def index(self) -> dict[tuple[int, int], int]:
        return {l: i for i, l in enumerate(self.links)}

    @property
    def n_links(self) -> int:
        return len(self.links)

    @property
    def n_mesh_links_directed(self) -> int:
        """Directed mesh (NoP) links — the enumeration prefix before the
        2·n_nodes memory ports. The single source of the layout split."""
        return self.n_links - 2 * self.n_nodes

    def node_rc(self, n: int) -> tuple[int, int]:
        return divmod(n, self.Y)

    # -------------------------------------------------------------- routes
    def xy_route(self, src: int, dst: int) -> list[tuple[int, int]]:
        """Dimension-ordered (row-first) XY route, as directed link keys."""
        Y = self.Y
        links = []
        r, c = self.node_rc(src)
        r1, c1 = self.node_rc(dst)
        while r != r1:
            nr = r + (1 if r1 > r else -1)
            links.append((r * Y + c, nr * Y + c))
            r = nr
        while c != c1:
            nc = c + (1 if c1 > c else -1)
            links.append((r * Y + c, r * Y + nc))
            c = nc
        return links

    def pull_route(self, attach: list[int], dst: int,
                   via: int | None = None) -> list[tuple[int, int]]:
        """Memory → ``dst``: enter through ``via`` (or the nearest attach
        chiplet), then XY."""
        a = via if via is not None else nearest_attach(attach, dst, self.Y)
        return [(self.mem, a)] + self.xy_route(a, dst)

    def push_route(self, attach: list[int], src: int,
                   via: int | None = None) -> list[tuple[int, int]]:
        """``src`` → memory: XY to ``via`` (or the nearest attach
        chiplet), then out through its port."""
        a = via if via is not None else nearest_attach(attach, src, self.Y)
        return self.xy_route(src, a) + [(a, self.mem)]

    def _incidence(self, routes: list[list[tuple[int, int]]]) -> np.ndarray:
        inc = np.zeros((len(routes), self.n_links), dtype=np.float64)
        idx = self.index
        for f, route in enumerate(routes):
            for l in route:
                inc[f, idx[l]] = 1.0
        return inc

    def pull_incidence(self, attach: list[int],
                       assign: np.ndarray | None = None) -> np.ndarray:
        """Route-incidence matrix ``[n_nodes, n_links]`` for one flow per
        chiplet pulling from memory. ``assign[f]`` (optional) picks the
        entrance *node id* each chiplet enters through; default is
        nearest-attach."""
        return self._incidence([
            self.pull_route(attach, d,
                            None if assign is None else int(assign[d]))
            for d in range(self.n_nodes)])

    def push_incidence(self, attach: list[int],
                       assign: np.ndarray | None = None) -> np.ndarray:
        """Route-incidence matrix for one flow per chiplet pushing its
        output to memory (the collection phase)."""
        return self._incidence([
            self.push_route(attach, s,
                            None if assign is None else int(assign[s]))
            for s in range(self.n_nodes)])

    def link_caps(self, bw_nop, bw_mem: float, attach: list[int],
                  mem_scale=None) -> np.ndarray:
        """Per-link capacities ``[n_links]``: mesh links at ``bw_nop``,
        every memory port at ``bw_mem / len(attach)`` (iso-total-bandwidth
        split; non-attach ports carry no flows, so their value is inert
        but keeps the array batchable across attachment sets).

        ``bw_nop`` may be a per-chiplet ``[n_nodes]`` array (heterogeneous
        grids): a mesh link then runs at the min of its endpoint rates.
        ``mem_scale`` (optional ``[n_nodes]``) scales each chiplet's port
        share. With equal-element arrays both reduce bitwise to the
        scalar capacities."""
        b = np.asarray(bw_nop, dtype=np.float64)
        cap = np.empty(self.n_links, dtype=np.float64)
        n_mesh = self.n_mesh_links_directed
        if b.ndim == 0:
            cap[:n_mesh] = b
        elif n_mesh:
            uv = np.asarray(self.links[:n_mesh])
            cap[:n_mesh] = np.minimum(b[uv[:, 0]], b[uv[:, 1]])
        per_port = float(bw_mem) / max(len(attach), 1)
        if mem_scale is None:
            cap[n_mesh:] = per_port
        else:
            s = np.asarray(mem_scale, dtype=np.float64)
            node = np.arange(self.n_nodes)
            cap[n_mesh:] = np.concatenate(
                [per_port * s[node], per_port * s[node]])
        return cap

    def mesh_link_mask(self) -> np.ndarray:
        """Boolean ``[n_links]``: True for mesh (NoP) links, False for
        memory ports."""
        m = np.zeros(self.n_links, dtype=bool)
        m[: self.n_mesh_links_directed] = True
        return m
