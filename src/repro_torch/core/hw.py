"""Hardware model for MCM (multi-chip-module) systems — paper Sec. 4.1/4.2.1.

Defines the four packaging types (Fig. 2/4), the Table-2 energy/bandwidth
constants, and the chiplet-grid :class:`Topology`: per-chiplet local
indices (x, y) relative to the nearest "global chiplet" (memory entrance),
hop-count matrices for every communication case in Sec. 4.3 (including the
diagonal link strategy of Sec. 5.1), the entrance link counts used by
the collection equation (eq. 8), and the link-level flow network consumed
by the ``congestion="flow"`` evaluator mode.

The port's copy of the JAX package's ``core/hw.py``, plain numpy. All
geometry primitives live in :mod:`.topology`; this module composes them
per :class:`HWConfig` and is the one place the rest of the port reads
topology facts from, computed once per (HWConfig) and then consumed as
constants by the evaluator.
"""
from __future__ import annotations

import dataclasses
import enum
from functools import cached_property

import numpy as np

from . import topology as topo

__all__ = [
    "MCMType",
    "ChipletClass",
    "HWConfig",
    "Topology",
    "TABLE2",
    "make_hw",
]


class MCMType(str, enum.Enum):
    """Packaging types from Fig. 2 — position of main memory vs chiplets.

    A: 2.5D, single memory stack at a corner (SIMBA / Manticore).
    B: 2.5D, memory stacks distributed along the left+right edges (MTIA).
    C: 3D, memory stacked on top of every chiplet.
    D: hybrid of B and C — edge stacks plus 3D memory on the interior quad
       (Chiplet-Gym-style); memory distance is near-uniform.
    """

    A = "A"
    B = "B"
    C = "C"
    D = "D"


#: Table 2 — MCMComm system configurations. Bandwidths in bytes/s, energies
#: in Joules/bit (pJ converted), MAC energy in Joules/cycle.
TABLE2 = {
    "bw_hbm": 1000e9,          # 1000 GB/s
    "bw_dram": 60e9,           # 60 GB/s
    "bw_nop": 60e9,            # 60 GB/s per NoP link
    "e_nop_bit_hop": 1.285e-12,
    "e_dram_bit": 14.8e-12,
    "e_hbm_bit": 4.11e-12,
    "e_sram_bit": 0.28e-12,
    "e_mac_cycle": 4.6e-12,
    "freq_hz": 1.0e9,          # 1 GHz chiplet clock (SCALE-Sim default class)
}


@dataclasses.dataclass(frozen=True)
class ChipletClass:
    """One hardware class in a heterogeneous chiplet grid (SCAR-style).

    A class scales the three per-chiplet rates relative to the package
    baseline: ``freq_hz`` and ``bw_nop`` are absolute rates for chiplets
    of this class, ``mem_scale`` multiplies the chiplet's share of the
    off-chip bandwidth (1.0 = the homogeneous iso-split share). Defaults
    reproduce the Table-2 baseline exactly, so a one-class grid is the
    homogeneous machine.
    """

    name: str = "base"
    freq_hz: float = TABLE2["freq_hz"]
    bw_nop: float = TABLE2["bw_nop"]
    mem_scale: float = 1.0

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        """Re-runnable rate validation (unpickling bypasses
        ``__post_init__``, so callers may run it again)."""
        for f in ("freq_hz", "bw_nop", "mem_scale"):
            v = getattr(self, f)
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or not np.isfinite(v) or v <= 0:
                raise ValueError(
                    f"ChipletClass.{f} must be a finite positive rate, "
                    f"got {v!r}")


@dataclasses.dataclass(frozen=True)
class HWConfig:
    """``HW = {BW_nop, BW_mem, X, Y, R, C, type}`` — paper eq. in Sec 4.2.1.

    ``bw_mem`` is the *total* off-chip bandwidth of the package; it is split
    evenly across memory entrances for types B/C/D so that packaging types
    are iso-bandwidth comparable (the paper's Fig. 3(c) experiment keeps a
    single memory node and moves it; ``n_mem_nodes=1`` reproduces that).
    """

    bw_nop: float = TABLE2["bw_nop"]
    bw_mem: float = TABLE2["bw_hbm"]
    X: int = 4
    Y: int = 4
    R: int = 16
    C: int = 16
    mcm_type: MCMType = MCMType.A
    diagonal_links: bool = False
    freq_hz: float = TABLE2["freq_hz"]
    bytes_per_elem: int = 1            # int8 edge-inference datapath
    # Energy constants (overridable for sensitivity studies).
    e_nop_bit_hop: float = TABLE2["e_nop_bit_hop"]
    e_mem_bit: float = TABLE2["e_hbm_bit"]
    e_sram_bit: float = TABLE2["e_sram_bit"]
    e_mac_cycle: float = TABLE2["e_mac_cycle"]
    # Heterogeneous chiplet grid (empty = homogeneous): a table of
    # :class:`ChipletClass` rows plus a row-major ``[X·Y]`` assignment of
    # each chiplet to a class index. Tuples keep the config hashable.
    chiplet_classes: tuple = ()
    class_assignment: tuple = ()

    def __post_init__(self):
        # Normalize list inputs to tuples so equal configs hash equal.
        if not isinstance(self.chiplet_classes, tuple):
            object.__setattr__(self, "chiplet_classes",
                               tuple(self.chiplet_classes))
        if not isinstance(self.class_assignment, tuple):
            object.__setattr__(self, "class_assignment",
                               tuple(int(i) for i in self.class_assignment))
        self.validate()

    def validate(self) -> None:
        """Full field validation, re-runnable on an already-constructed
        instance (unpickling via ``__setstate__`` bypasses
        ``__post_init__``)."""
        if self.X < 1 or self.Y < 1:
            raise ValueError("grid must be at least 1x1")
        if self.R < 1 or self.C < 1:
            raise ValueError("systolic array must be at least 1x1")
        for f in ("bw_nop", "bw_mem", "freq_hz"):
            v = getattr(self, f)
            if not np.isfinite(v) or v <= 0:
                raise ValueError(
                    f"HWConfig.{f} must be a finite positive rate, "
                    f"got {v!r}")
        classes, assign = self.chiplet_classes, self.class_assignment
        if bool(classes) != bool(assign):
            raise ValueError(
                "chiplet_classes and class_assignment must be set "
                "together (both empty = homogeneous)")
        if not classes:
            return
        for c in classes:
            if not isinstance(c, ChipletClass):
                raise ValueError(
                    f"chiplet_classes entries must be ChipletClass, "
                    f"got {type(c).__name__}")
            c.validate()
        if len(assign) != self.X * self.Y:
            raise ValueError(
                f"class_assignment must have X*Y={self.X * self.Y} "
                f"entries (row-major), got {len(assign)}")
        n = len(classes)
        for i in assign:
            if not isinstance(i, (int, np.integer)) \
                    or isinstance(i, bool) or not 0 <= i < n:
                raise ValueError(
                    f"class_assignment index {i!r} out of range for "
                    f"{n} chiplet class(es)")

    @classmethod
    def hetero(cls, classes, assignment, **kw) -> "HWConfig":
        """Heterogeneous constructor: ``classes`` is a sequence of
        :class:`ChipletClass`, ``assignment`` the row-major ``[X·Y]``
        class index per chiplet. One class broadcast everywhere is
        bitwise-identical to the legacy scalar config — the migration
        gate every engine is tested against."""
        return cls(chiplet_classes=tuple(classes),
                   class_assignment=tuple(int(i) for i in assignment),
                   **kw)

    @property
    def is_hetero(self) -> bool:
        return bool(self.chiplet_classes)

    # Per-chiplet rate views ``[X, Y]`` (float64). Homogeneous configs
    # broadcast the scalar fields, so downstream elementwise math is
    # bitwise-identical to the scalar code it replaced; hetero configs
    # gather the class table through the assignment.
    @cached_property
    def bw_nop_xy(self) -> np.ndarray:
        if not self.is_hetero:
            return np.full((self.X, self.Y), float(self.bw_nop))
        vals = np.array([c.bw_nop for c in self.chiplet_classes])
        return vals[np.array(self.class_assignment)].reshape(
            self.X, self.Y)

    @cached_property
    def freq_xy(self) -> np.ndarray:
        if not self.is_hetero:
            return np.full((self.X, self.Y), float(self.freq_hz))
        vals = np.array([c.freq_hz for c in self.chiplet_classes])
        return vals[np.array(self.class_assignment)].reshape(
            self.X, self.Y)

    @cached_property
    def mem_scale_xy(self) -> np.ndarray:
        if not self.is_hetero:
            return np.ones((self.X, self.Y))
        vals = np.array([c.mem_scale for c in self.chiplet_classes])
        return vals[np.array(self.class_assignment)].reshape(
            self.X, self.Y)

    @property
    def n_chiplets(self) -> int:
        return self.X * self.Y

    @cached_property
    def topology(self) -> "Topology":
        return Topology(self)

    # Pickle only the declared fields: the default protocol would drag
    # the cached ``topology`` (hop matrices, flow nets) along — and the
    # unpickled copy must hash/compare equal to a fresh HWConfig, which
    # field-only state guarantees.
    def __getstate__(self):
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    def __setstate__(self, state):
        for k, v in state.items():
            object.__setattr__(self, k, v)

    def replace(self, **kw) -> "HWConfig":
        return dataclasses.replace(self, **kw)


def _entrances(hw: HWConfig) -> list[tuple[int, int, str]]:
    """Memory entrance chiplets as (gx, gy, kind) with kind in
    {"corner", "edge", "3d"} (:func:`.topology.entrances`)."""
    return topo.entrances(hw.mcm_type, hw.X, hw.Y)


class Topology:
    """Precomputed per-chiplet indexing and hop matrices for one HWConfig.

    Arrays are indexed [gx, gy] over the *global* grid. Chiplets are grouped
    by their nearest memory entrance; within a group, (x, y) are the local
    indices of Sec. 4.2.1 ("rows and columns away from the global chiplet")
    and (Xg, Yg) the group extents that replace the global X, Y in the hop
    equations (for type A the group is the whole grid, so they coincide).
    """

    def __init__(self, hw: HWConfig):
        self.hw = hw
        X, Y = hw.X, hw.Y
        ents = _entrances(hw)
        self.entrances = ents
        self.n_entrances = len(ents)

        # Nearest-entrance grouping + Sec. 4.2.1 local indices.
        (self.entrance_id, self.x_local, self.y_local,
         self.Xg, self.Yg) = topo.assign_entrances(X, Y, ents)

        # Entrance link counts (for eq. 8 collection bandwidth). The
        # entrance chiplet's own data never crosses the NoP (it sits on the
        # off-chip port / 3D via), so collection counts only non-entrance
        # bytes; the links are the mesh links incident to the entrance.
        kinds = [e[2] for e in ents]
        self.entrance_links = np.array(
            [
                topo.n_mesh_links(exi, eyi, X, Y, hw.diagonal_links)
                for (exi, eyi, k) in ents
            ]
        )
        # Per-entrance masks (one-hot positions, membership, row/column
        # projections — the evaluator's serialization terms).
        (self.entrance_member, self.entrance_pos,
         self.entrance_rows, self.entrance_cols) = topo.entrance_masks(
            X, Y, ents, self.entrance_id)
        self.entrance_is_3d = np.array([k == "3d" for k in kinds])
        # Per-chiplet: is its entrance a 3D (zero-hop) stack?
        self.is_3d = self.entrance_is_3d[self.entrance_id]

        # Per-entrance memory bandwidth share (iso-total-bandwidth).
        self.bw_mem_per_entrance = hw.bw_mem / self.n_entrances

        # Per-chiplet / per-entrance rate arrays (hetero grids; for a
        # homogeneous config these broadcast the scalars bitwise — the
        # ``* 1.0`` mem scale and equal-element arrays change nothing).
        self.bw_nop_xy = hw.bw_nop_xy                       # [X, Y]
        self.freq_xy = hw.freq_xy                           # [X, Y]
        ex = np.array([e[0] for e in ents])
        ey = np.array([e[1] for e in ents])
        self.bw_nop_entrance = self.bw_nop_xy[ex, ey]       # [E]
        self.bw_mem_entrance = (
            self.bw_mem_per_entrance * hw.mem_scale_xy[ex, ey])  # [E]

        # Chiplets per entrance group (for collection-link sharing).
        self.group_size = np.bincount(
            self.entrance_id.ravel(), minlength=self.n_entrances
        )

        self._build_hop_matrices()
        self._flow_net = None

    # ----------------------------------------------------------------- hops
    def _build_hop_matrices(self):
        hw = self.hw
        # eq. 10 (low BW minimal path), eq. 11/12 (high-BW row/col-shared
        # with farthest-first waiting), Sec. 5.1.1 diagonal alternative.
        self.hops_low, self.hops_row_shared, self.hops_col_shared = \
            topo.hop_matrices(self.x_local, self.y_local, self.Xg, self.Yg,
                              hw.diagonal_links)

        # 3D-stacked chiplets read memory directly: zero NoP hops.
        for a in ("hops_low", "hops_row_shared", "hops_col_shared"):
            m = getattr(self, a).copy()
            m[self.is_3d & (self.x_local == 0) & (self.y_local == 0)] = 0
            setattr(self, a, m)

        # Collection (eq. 8) effective entrance link bandwidth per group —
        # number of NoP links into the entrance chiplet; 3D entrances
        # collect at memory bandwidth directly (no NoP bottleneck).
        self.collect_links = np.maximum(self.entrance_links, 0)

    # ------------------------------------------------------- flow network
    @property
    def mesh_graph(self) -> topo.MeshGraph:
        return topo.MeshGraph(self.hw.X, self.hw.Y)

    def flow_net(self):
        """Link-level flow network for ``congestion="flow"`` (DESIGN.md
        §11): ``(link_cap [L], dist_inc [X·Y, L], coll_inc [X·Y, L])``.

        One *mesh-only* flow per chiplet, routed assigned entrance → XY
        for the distribution phase and the reverse for collection
        (chiplets use their hop-model entrance, ``entrance_id``, so the
        flow and regime modes agree on which entrance serves which
        chiplet). The memory-port columns are zeroed out of the
        incidence: off-chip serialization stays the exact closed-form
        per-entrance term — a port is used only by its own group, so
        waterfilling it adds nothing, and shared row/column stripes are
        fetched once per group (the paper's multicast accounting), not
        once per chiplet. Only NoP delivery — which the paper does count
        per chiplet — is simulated. A chiplet sitting on its entrance
        (or under a 3D stack) has an empty mesh route: its incidence row
        is zero and the evaluator masks its simulated demand to zero.
        """
        if self._flow_net is None:
            hw = self.hw
            g = self.mesh_graph
            Y = hw.Y
            attach = [ex * Y + ey for ex, ey, _ in self.entrances]
            assign = np.array(
                [attach[e] for e in self.entrance_id.ravel()])
            dist = g.pull_incidence(attach, assign)
            coll = g.push_incidence(attach, assign)
            ports = ~g.mesh_link_mask()
            dist[:, ports] = 0.0
            coll[:, ports] = 0.0
            self._flow_net = (
                g.link_caps(hw.bw_nop_xy.ravel(), hw.bw_mem, attach,
                            mem_scale=hw.mem_scale_xy.ravel()),
                dist,
                coll,
            )
        return self._flow_net

    # ------------------------------------------------------------- helpers
    def describe(self) -> str:
        hw = self.hw
        lines = [
            f"MCM type {hw.mcm_type.value}: {hw.X}x{hw.Y} chiplets, "
            f"{hw.R}x{hw.C} systolic, NoP {hw.bw_nop/1e9:.0f} GB/s, "
            f"mem {hw.bw_mem/1e9:.0f} GB/s over {self.n_entrances} "
            f"entrance(s), diagonal={hw.diagonal_links}",
            f"entrance links: {self.entrance_links.tolist()}",
        ]
        return "\n".join(lines)


def make_hw(
    mcm_type: str | MCMType = "A",
    grid: int | tuple[int, int] = 4,
    memory: str = "hbm",
    diagonal_links: bool = False,
    **kw,
) -> HWConfig:
    """Convenience constructor: ``make_hw("A", 4, "hbm")``."""
    if isinstance(grid, int):
        grid = (grid, grid)
    bw_mem = TABLE2["bw_hbm"] if memory.lower() == "hbm" else TABLE2["bw_dram"]
    e_mem = TABLE2["e_hbm_bit"] if memory.lower() == "hbm" else TABLE2["e_dram_bit"]
    return HWConfig(
        X=grid[0],
        Y=grid[1],
        mcm_type=MCMType(mcm_type),
        bw_mem=bw_mem,
        e_mem_bit=e_mem,
        diagonal_links=diagonal_links,
        **kw,
    )
