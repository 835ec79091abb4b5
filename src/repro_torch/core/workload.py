"""Workload model — paper Sec. 4.2.2/4.2.3.

A machine-learning task is a topologically-ordered sequence of GEMM
operators (eq. 1/2). Each operator carries the synchronization / sharing
attributes the communication model needs, plus a ``chained`` flag marking
that its activation input is the previous operator's output (the case
on-package redistribution, Sec. 5.2, optimizes).

SIMD-class operators (ReLU, softmax, layernorm — Sec. 4.2.2) are modeled as
attributes of the preceding GEMM: ``epilogue_flops_per_elem`` adds vector
cycles, and ``sync=True`` forces an output synchronization (softmax /
layernorm over distributed outputs).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["GemmOp", "Task", "uniform_partition", "partition_domain", "Partition"]


@dataclasses.dataclass(frozen=True)
class GemmOp:
    """One GEMM: out[M, N] = inp[M, K] @ w[K, N] (paper eq. 2)."""

    name: str
    M: int
    K: int
    N: int
    sync: bool = False          # output must synchronize across chiplets
    shared_row: bool = False    # chiplets of same row produce same out rows
    shared_col: bool = False
    chained: bool = False       # activation input = previous op's output
    weight_bytes_scale: float = 1.0  # grouped GEMMs reuse one weight tile
    epilogue_flops_per_elem: int = 0  # SIMD epilogue (ReLU=1, softmax≈5, ...)
    n_groups: int = 1           # grouped GEMM (e.g. attention heads)

    def __post_init__(self):
        for d in (self.M, self.K, self.N):
            if d < 1:
                raise ValueError(f"bad GEMM dims in {self.name}: "
                                 f"{self.M}x{self.K}x{self.N}")

    @property
    def flops(self) -> int:
        return 2 * self.M * self.K * self.N

    @property
    def out_elems(self) -> int:
        return self.M * self.N

    @property
    def in_elems(self) -> int:
        return self.M * self.K

    @property
    def w_elems(self) -> int:
        return int(self.K * self.N * self.weight_bytes_scale)


@dataclasses.dataclass
class Task:
    """``Task = [OP_0 .. OP_{N-1}]`` (eq. 1) plus metadata."""

    name: str
    ops: list[GemmOp]

    def __post_init__(self):
        if not self.ops:
            raise ValueError("empty task")

    def __len__(self) -> int:
        return len(self.ops)

    def __iter__(self):
        return iter(self.ops)

    @property
    def total_flops(self) -> int:
        return sum(op.flops for op in self.ops)

    def arrays(self) -> dict[str, np.ndarray]:
        """Stack op attributes into arrays for the vectorized evaluator."""
        f = lambda a: np.array([getattr(op, a) for op in self.ops])
        return {
            "M": f("M"),
            "K": f("K"),
            "N": f("N"),
            "sync": f("sync"),
            "shared_row": f("shared_row"),
            "shared_col": f("shared_col"),
            "chained": f("chained"),
            "w_scale": f("weight_bytes_scale"),
            "epilogue": f("epilogue_flops_per_elem"),
        }

    def describe(self) -> str:
        rows = [f"Task {self.name}: {len(self.ops)} GEMMs, "
                f"{self.total_flops/1e9:.2f} GFLOPs"]
        for op in self.ops:
            flags = "".join(
                c
                for c, v in zip("scr", (op.sync, op.chained, op.shared_row))
                if v
            )
            rows.append(
                f"  {op.name:<24} M={op.M:<7} K={op.K:<7} N={op.N:<7} {flags}"
            )
        return "\n".join(rows)


# --------------------------------------------------------------------------
# Partitions (Sec. 4.2.3): Px[i, x] output rows on chiplet-row x for op i,
# Py[i, y] output cols on chiplet-col y; collectors[i] is the collection
# column used by on-package redistribution (a GA gene, Sec. 6.2).
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Partition:
    Px: np.ndarray          # [n_ops, X] ints, rows sum to M_i
    Py: np.ndarray          # [n_ops, Y] ints, rows sum to N_i
    collectors: np.ndarray  # [n_ops] ints in [0, Y)

    def validate(self, task: Task) -> None:
        n = len(task)
        assert self.Px.shape[0] == n and self.Py.shape[0] == n
        for i, op in enumerate(task.ops):
            sx, sy = int(self.Px[i].sum()), int(self.Py[i].sum())
            if sx != op.M:
                raise ValueError(f"{op.name}: sum(Px)={sx} != M={op.M}")
            if sy != op.N:
                raise ValueError(f"{op.name}: sum(Py)={sy} != N={op.N}")
            if (self.Px[i] < 0).any() or (self.Py[i] < 0).any():
                raise ValueError(f"{op.name}: negative partition")

    def copy(self) -> "Partition":
        return Partition(self.Px.copy(), self.Py.copy(), self.collectors.copy())


def _split_even(total: int, parts: int) -> np.ndarray:
    """Uniform split with remainder spread over the first entries."""
    base, rem = divmod(total, parts)
    out = np.full(parts, base, dtype=np.int64)
    out[:rem] += 1
    return out


def uniform_partition(task: Task, X: int, Y: int) -> Partition:
    """The paper's LS baseline: uniform workload partitioning."""
    Px = np.stack([_split_even(op.M, X) for op in task.ops])
    Py = np.stack([_split_even(op.N, Y) for op in task.ops])
    return Partition(Px, Py, np.full(len(task), Y // 2, dtype=np.int64))


def partition_domain(
    task: Task, X: int, Y: int, R: int, C: int, slack: int = 2
) -> tuple[np.ndarray, np.ndarray]:
    """Solver search windows from Sec. 6.2.

    Each Px_i[x] is constrained to multiples of R within
    ``[max(R, R*(ceil(M/X/R) - slack)), R*(ceil(M/X/R) + slack)]`` (and the
    symmetric window in C for Py); smaller would under-utilize the systolic
    array. Returns (lo, hi) arrays of shape [n_ops, 2] holding the inclusive
    multiple-of-R index window for rows ([:,0] -> Px) and cols ([:,1] -> Py).
    """
    lo = np.zeros((len(task), 2), dtype=np.int64)
    hi = np.zeros((len(task), 2), dtype=np.int64)
    for i, op in enumerate(task.ops):
        ux = max(1, int(np.ceil(op.M / X / R)))   # uniform share in R units
        uy = max(1, int(np.ceil(op.N / Y / C)))
        # If there are fewer R-units than chiplet rows, some rows must idle:
        # the paper's "min Px = R" floor only applies when work suffices.
        floor_x = 1 if int(np.ceil(op.M / R)) >= X else 0
        floor_y = 1 if int(np.ceil(op.N / C)) >= Y else 0
        lo[i, 0] = max(floor_x, ux - slack)
        hi[i, 0] = ux + slack
        lo[i, 1] = max(floor_y, uy - slack)
        hi[i, 1] = uy + slack
    return lo, hi


def clamp_partition_to_domain(
    part: Partition, task: Task, X: int, Y: int, R: int, C: int, slack: int = 2
) -> Partition:
    """Project an arbitrary partition into the solver domain: multiples of
    R/C inside the Sec-6.2 window, then fix the sum by adjusting entries
    greedily (keeps feasibility invariant for GA mutations)."""
    lo, hi = partition_domain(task, X, Y, R, C, slack)
    out = part.copy()
    for i, op in enumerate(task.ops):
        out.Px[i] = _repair_axis(out.Px[i], op.M, R, lo[i, 0], hi[i, 0])
        out.Py[i] = _repair_axis(out.Py[i], op.N, C, lo[i, 1], hi[i, 1])
    out.collectors = np.clip(out.collectors, 0, Y - 1)
    return out


def _repair_axis(p: np.ndarray, total: int, unit: int, lo: int, hi: int
                 ) -> np.ndarray:
    """Snap to units, clamp to window, then repair the sum.

    The last entry absorbs the residual so that sums stay exact even when
    ``total`` is not a multiple of ``unit`` (real layer dims rarely are).
    """
    n = len(p)
    units = np.clip(np.round(p / unit).astype(np.int64), lo, hi)
    vals = units * unit
    resid = total - int(vals.sum())
    j = 0
    # Greedy repair: walk entries, move one unit at a time within bounds.
    guard = 0
    while resid >= unit or resid <= -unit:
        guard += 1
        if guard > 10 * n * (hi - lo + 2):
            break
        k = j % n
        if resid > 0 and units[k] < hi:
            units[k] += 1
            resid -= unit
        elif resid < 0 and units[k] > lo:
            units[k] -= 1
            resid += unit
        j += 1
    vals = units * unit
    # Absorb sub-unit residue (and any window-infeasible remainder) in the
    # largest entry, keeping non-negativity.
    resid = total - int(vals.sum())
    k = int(np.argmax(vals))
    vals[k] = max(0, vals[k] + resid)
    # Final exactness fix (can only trigger if vals[k] clipped at 0).
    d = total - int(vals.sum())
    if d != 0:
        k2 = int(np.argmax(vals))
        vals[k2] += d
    return vals
