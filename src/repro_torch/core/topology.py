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

The JAX package's link-level graph (``MeshGraph``: directed links, XY
routing, route incidence matrices) feeds only its flow netsim, so it
comes with the port's netsim (ROADMAP.md, A.5).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "entrances",
    "n_mesh_links",
    "assign_entrances",
    "hop_matrices",
    "entrance_masks",
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
