"""End-to-end analytical cost evaluator — paper Sec. 4.2.4–4.4 and 5.1–5.3.

Implements ``Cost = Sche({comp(*_i), comm(*_i)})`` (eq. 3–6) for a Task on
an HWConfig under a candidate Partition, returning latency, energy and EDP
plus a per-op breakdown that a cross-sample pipeliner (Sec. 5.4) consumes.

The port's copy of the JAX package's ``core/evaluator.py``. All math is
vectorized with a leading *population* axis so that the genetic
algorithm (Sec. 6.2) evaluates its whole population in one call.
float64 throughout — cycle counts overflow float32 mantissas.

Two interchangeable backends, as in the JAX package:
  * ``backend="numpy"`` — the reference implementation (this module);
  * ``backend="torch"`` — the same equations on float64 torch tensors on
    an explicit device (:mod:`.evaluator_torch`, the counterpart of the
    JAX package's ``evaluator_jax``), held to the reference at rtol 1e-9.

Modeling conventions:
  * Off-chip and NoP serialization per phase combine as ``max`` — the
    congestion-aware regime pick of Sec. 3.2/4.3.3 (memory-bound vs
    NoP-bound); the slower resource is the bottleneck. That is
    ``congestion="regime"``; ``congestion="flow"`` instead scores the
    distribution/collection phases against link rates simulated by the
    max-min waterfilling netsim (:mod:`.netsim`) on the topology's flow
    network (energy is congestion-independent).
  * Per-chiplet NoP time for distribution = received_bytes × hops / BW_nop
    with the hop matrices of eqs. 10–12 (+ the diagonal-link alternative
    of Sec. 5.1.1 taken as a per-chiplet min).
  * Collection (eq. 8) = non-entrance group bytes / (entrance_links × BW).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .hw import HWConfig
from .workload import Partition, Task

__all__ = ["AUTO_POPULATION_THRESHOLD", "BACKENDS", "CONGESTION_MODES",
           "DEVICE_MODES", "EvalOptions", "EvalResult", "Evaluator",
           "resolve_auto_backend"]


#: Congestion models for the communication phases: "regime" = the
#: closed-form max-pick of Sec. 3.2/4.3.3 (memory-bound vs NoP-bound,
#: whichever serializes longer); "flow" = score the
#: distribution/collection phases against link rates simulated by the
#: max-min waterfilling netsim on the shared topology's flow network.
CONGESTION_MODES = ("regime", "flow")

#: Execution modes for the batched sweep calls (DESIGN.md §15):
#: "single" = one device runs the whole grid group; "sharded" = the grid
#: axis is split across devices (:mod:`.sweep_shard`); "auto" = sharded
#: iff more than one card exists and the group has >= 2 points. Results
#: are bitwise identical across modes (solo == batched == sharded), so
#: the knob is purely a performance choice and is normalized out of
#: every sweep-cache fingerprint.
DEVICE_MODES = ("single", "sharded", "auto")


@dataclasses.dataclass(frozen=True)
class EvalOptions:
    """Optimization toggles (Sec. 5). The LS baseline has all False."""

    redistribution: bool = False   # Sec. 5.2 on-package redistribution
    async_exec: bool = False       # Sec. 5.3 fused comm+comp
    energy_mode: str = "paper"     # "paper" (eq. 4.4.1 verbatim) | "per_chiplet"
    congestion: str = "regime"     # "regime" (Sec. 4.3.3) | "flow" (netsim)
    devices: str = "auto"          # sweep execution: "single"|"sharded"|
                                   # "auto" (§15; result-neutral)

    def __post_init__(self):
        if self.energy_mode not in ("paper", "per_chiplet"):
            raise ValueError(f"bad energy_mode {self.energy_mode}")
        if self.congestion not in CONGESTION_MODES:
            raise ValueError(f"bad congestion {self.congestion!r}; "
                             f"one of {CONGESTION_MODES}")
        if self.devices not in DEVICE_MODES:
            raise ValueError(f"bad devices {self.devices!r}; "
                             f"one of {DEVICE_MODES}")


@dataclasses.dataclass
class EvalResult:
    latency: float            # seconds
    energy: float             # joules
    edp: float                # J*s
    t_in: np.ndarray          # [n_ops] input-communication seconds
    t_comp: np.ndarray        # [n_ops]
    t_out: np.ndarray         # [n_ops] offload-or-redistribution seconds
    redist: np.ndarray        # [n_ops] bool, redistribution used after op i

    def segments(self) -> list[tuple[str, float, float, float]]:
        """(name, comm_in, comp, comm_out) per op for the pipeliner."""
        return [
            (f"op{i}", float(self.t_in[i]), float(self.t_comp[i]),
             float(self.t_out[i]))
            for i in range(len(self.t_in))
        ]


BACKENDS = ("numpy", "torch", "auto")

#: ``backend="auto"`` crossover point: torch at or above this population
#: size, numpy below (below it the ~140 launches and 14 copies of a
#: torch call cost more than numpy's work). Measured on an H100 by
#: ``chip_smoke.py``'s phase 6 on ViT-B/16's 74 ops (PERF.md §5-6):
#: torch on the card first beats numpy at P = 32 (the JAX package's
#: 1024 was its jax backend's crossover on a CPU container). Tasks with
#: fewer ops cross over later: numpy's time scales with P x ops.
AUTO_POPULATION_THRESHOLD = 32


def resolve_auto_backend(backend: str, population: int) -> str:
    """Resolve ``"auto"`` to a concrete engine for a given batch size:
    torch at ``population >= AUTO_POPULATION_THRESHOLD``, numpy below.
    The choice never depends on whether a card is present: torch on
    ``device=None`` means the card, and raises without one."""
    if backend == "auto":
        return ("torch" if population >= AUTO_POPULATION_THRESHOLD
                else "numpy")
    return backend


class Evaluator:
    """Evaluates partitions for one (Task, HWConfig, EvalOptions) triple.

    ``backend`` selects the execution engine: ``"numpy"`` (reference) or
    ``"torch"`` (float64 torch on ``device``; ``None`` means the card).
    Both produce identical result dicts of float64 numpy arrays.
    ``"auto"`` defers the choice to each ``evaluate_batch`` call: torch
    for populations ≥ :data:`AUTO_POPULATION_THRESHOLD`, numpy below.

    ``congestion`` (shorthand for ``options.congestion``) selects the
    communication model: ``"regime"`` keeps the closed-form Sec. 3.2/4.3.3
    max pick, ``"flow"`` scores distribution/collection against the
    simulated link rates of the waterfilling netsim.
    """

    def __init__(self, task: Task, hw: HWConfig,
                 options: EvalOptions = EvalOptions(),
                 backend: str = "numpy", device=None,
                 congestion: str | None = None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
        if congestion is not None:
            # Constructor override of the options field: the merged
            # options object is what travels into fingerprints.
            options = dataclasses.replace(options, congestion=congestion)
        self.backend = backend
        self.device = device
        self._consts = None          # lazy constant bundle (torch backend)
        self._device_consts = None   # its device-resident copy
        self.task = task
        self.hw = hw
        self.opts = options
        top = hw.topology
        self.top = top
        n = len(task)
        arr = task.arrays()
        self.M = arr["M"].astype(np.float64)
        self.K = arr["K"].astype(np.float64)
        self.N = arr["N"].astype(np.float64)
        self.sync = arr["sync"].astype(bool)
        self.w_scale = arr["w_scale"].astype(np.float64)
        self.epilogue = arr["epilogue"].astype(np.float64)

        # chain_valid[i]: redistribution after op i is semantically legal —
        # op i+1 consumes op i's output as its activation. Dims need not
        # match exactly (pooling / im2col between conv layers reshapes the
        # tensor locally in SRAM — the paper's AlexNet case); step 3 works
        # on normalized row fractions.
        cv = np.zeros(n, dtype=bool)
        for i in range(n - 1):
            cv[i] = bool(task.ops[i + 1].chained)
        self.chain_valid = cv

        # Topology constants. The scalar fields stay (callers read
        # them); the per-chiplet /
        # per-entrance arrays below are what the phase equations divide
        # by — for a homogeneous config every array broadcasts the
        # scalar, so the arithmetic is bitwise-identical to the scalar
        # code it replaced (same divisor element, same argmax).
        self.B = float(hw.bytes_per_elem)
        self.bw_nop = float(hw.bw_nop)
        self.bw_ent = float(top.bw_mem_per_entrance)
        self.freq = float(hw.freq_hz)
        self.bw_nop_xy = top.bw_nop_xy.astype(np.float64)      # [X, Y]
        self.freq_xy = top.freq_xy.astype(np.float64)          # [X, Y]
        self.bw_ent_e = top.bw_mem_entrance.astype(np.float64)  # [E]
        self.bw_nop_ent = top.bw_nop_entrance.astype(np.float64)  # [E]
        # Redistribution runs along rows (step 1/2) and across adjacent
        # rows (step 3): bottleneck at the slowest link on the path.
        self.row_bw = self.bw_nop_xy.min(axis=1)               # [X]
        self.cross_bw = (np.minimum(self.row_bw[:-1], self.row_bw[1:])
                         if hw.X > 1 else self.row_bw[:0])     # [X-1]
        self.bw_nop_min = float(self.bw_nop_xy.min())
        self.high_bw = (float(self.bw_ent_e.max())
                        > self.bw_nop_min)         # congestion regime
        self.hA = (top.hops_row_shared if self.high_bw else top.hops_low
                   ).astype(np.float64)            # A is row-shared
        self.hW = (top.hops_col_shared if self.high_bw else top.hops_low
                   ).astype(np.float64)            # W is col-shared
        self.h_min = top.hops_low.astype(np.float64)

        # Per-entrance masks come straight from the shared topology layer
        # — no local re-derivation.
        self.ent_mask = top.entrance_member        # [E, X, Y]
        self.row_mask = top.entrance_rows          # [E, X]
        self.col_mask = top.entrance_cols          # [E, Y]
        self.ent_pos = top.entrance_pos            # [E, X, Y]
        self.links = top.entrance_links.astype(np.float64)  # [E]

    # ------------------------------------------------------------------ API
    def evaluate(self, part: Partition, redist_mask: np.ndarray | None = None
                 ) -> EvalResult:
        part.validate(self.task)
        Px = part.Px[None].astype(np.float64)
        Py = part.Py[None].astype(np.float64)
        coll = part.collectors[None].astype(np.int64)
        if redist_mask is None:
            rd = (self.chain_valid & self.opts.redistribution)[None]
        else:
            rd = (np.asarray(redist_mask, dtype=bool) & self.chain_valid)[None]
            if not self.opts.redistribution:
                rd = np.zeros_like(rd)
        out = self.evaluate_batch(Px, Py, coll, rd.astype(np.float64))
        return EvalResult(
            latency=float(out["latency"][0]),
            energy=float(out["energy"][0]),
            edp=float(out["edp"][0]),
            t_in=out["t_in"][0],
            t_comp=out["t_comp"][0],
            t_out=out["t_out"][0],
            redist=rd[0],
        )

    def evaluate_batch(
        self,
        Px: np.ndarray,      # [P, n, X] float
        Py: np.ndarray,      # [P, n, Y] float
        collectors: np.ndarray,  # [P, n] int
        redist: np.ndarray,  # [P, n] float in {0,1}: redistribute after op i
    ) -> dict[str, np.ndarray]:
        backend = resolve_auto_backend(self.backend, int(Px.shape[0]))
        if backend == "torch":
            from . import evaluator_torch
            if self._device_consts is None:
                self._device_consts = evaluator_torch.to_device(
                    self.consts(), self.device)
            return evaluator_torch.batch_evaluate(
                self._device_consts, self.opts, Px, Py, collectors, redist,
                self.device)
        return self._evaluate_batch_numpy(Px, Py, collectors, redist)

    def consts(self):
        """Constant bundle for the torch backend (cached)."""
        if self._consts is None:
            from . import evaluator_torch
            self._consts = evaluator_torch.consts_from_evaluator(self)
        return self._consts

    def _evaluate_batch_numpy(
        self, Px, Py, collectors, redist
    ) -> dict[str, np.ndarray]:
        hw, top = self.hw, self.top
        B = self.B
        bw_ent = self.bw_ent_e[None, None]                       # [1,1,E]
        X, Y = hw.X, hw.Y
        R, C = float(hw.R), float(hw.C)
        M, K, N = self.M, self.K, self.N

        redist = redist * self.chain_valid[None, :]
        if not self.opts.redistribution:
            redist = np.zeros_like(redist)
        # redist_in[i] = output of op i-1 was redistributed (A already local).
        redist_in = np.concatenate(
            [np.zeros_like(redist[:, :1]), redist[:, :-1]], axis=1)
        keepA = 1.0 - redist_in       # fraction of A loads from memory
        redist_out = redist

        # -------------------------------------------------- data volumes
        chunk = Px[:, :, :, None] * Py[:, :, None, :] * B        # [P,n,X,Y]
        inA = Px * K[None, :, None] * B                          # [P,n,X]
        inW = Py * (K * self.w_scale)[None, :, None] * B         # [P,n,Y]

        # --------------------------------------------- phase 1: data load
        # Off-chip serialization per entrance (duplicated pulls per group —
        # the paper's LS data-duplication overhead shows up here).
        A_e = np.einsum("ex,pnx->pne", self.row_mask, inA)
        W_e = np.einsum("ey,pny->pne", self.col_mask, inW)
        t_off_in = ((keepA[..., None] * A_e + W_e) / bw_ent).max(axis=-1)

        # NoP distribution: per-chiplet received bytes × hops / BW.
        tA_xy = inA[:, :, :, None] * self.hA[None, None]          # bytes*hops
        tW_xy = inW[:, :, None, :] * self.hW[None, None]
        flow_mode = self.opts.congestion == "flow"
        if flow_mode:
            # Flow congestion: per-chiplet NoP arrival times from the
            # simulated mesh link rates replace the hop-matrix closed
            # form; off-chip serialization keeps the exact per-entrance
            # term (shared stripes are fetched once per group — simulating
            # the sole-user port would just re-derive t_off_in).
            demand = (keepA[..., None, None] * inA[:, :, :, None]
                      + inW[:, :, None, :])                      # [P,n,X,Y]
            dist_done, t_coll_flow = self._flow_times(demand, chunk)
            nop_in_xy = None          # regime-only (tA/tW still feed energy)
            t_in = np.maximum(t_off_in, dist_done.max(axis=(-1, -2)))
        else:
            nop_in_xy = ((keepA[..., None, None] * tA_xy + tW_xy)
                         / self.bw_nop_xy[None, None])
            t_in = np.maximum(t_off_in, nop_in_xy.max(axis=(-1, -2)))

        # ------------------------------------------------ phase 2: compute
        # SCALE-Sim output-stationary latency (eq. 7) + SIMD epilogue.
        fill = (2.0 * R + C + K - 2.0)[None, :, None, None]
        tiles = np.ceil(Px / R)[:, :, :, None] * np.ceil(Py / C)[:, :, None, :]
        cyc = fill * tiles
        cyc = cyc + (self.epilogue[None, :, None, None]
                     * Px[:, :, :, None] * Py[:, :, None, :] / C)
        t_comp_xy = cyc / self.freq_xy[None, None]
        t_comp = t_comp_xy.max(axis=(-1, -2))

        # ----------------------------------------- phase 3a: offload path
        # eq. 8 uses the *full* group bytes over the entrance links for 2.5D
        # packages; only a 3D entrance's own chunk bypasses the NoP (it sits
        # directly under its memory stack).
        out_e = np.einsum("exy,pnxy->pne", self.ent_mask, chunk)
        t_off_out = (out_e / bw_ent).max(axis=-1)
        if flow_mode:
            # Collection: simulated mesh-flow completion replaces the
            # entrance-link closed form; the off-chip write term stays.
            t_offload = np.maximum(t_coll_flow, t_off_out)
        else:
            out_at_ent = np.einsum("exy,pnxy->pne", self.ent_pos, chunk)
            is3d = self.top.entrance_is_3d[None, None, :]
            nonlocal_out = out_e - np.where(is3d, out_at_ent, 0.0)
            with np.errstate(divide="ignore", invalid="ignore"):
                t_collect = np.where(
                    self.links[None, None] > 0,
                    nonlocal_out
                    / (self.links[None, None] * self.bw_nop_ent[None, None]),
                    0.0,
                ).max(axis=-1)
            t_offload = np.maximum(t_collect, t_off_out)

        # --------------------------------- phase 3b: redistribution path
        # (Sec. 5.2) Step 1: row gather toward collector column c.
        yidx = np.arange(Y)[None, None, :]
        cc = collectors[..., None]
        left_m = (yidx < cc).astype(np.float64)                  # [P,n,Y]
        right_m = (yidx > cc).astype(np.float64)
        left_x = np.einsum("pnxy,pny->pnx", chunk, left_m)
        right_x = np.einsum("pnxy,pny->pnx", chunk, right_m)
        t1 = (np.maximum(left_x, right_x)
              / self.row_bw[None, None]).max(axis=-1)
        # Step 2: broadcast the assembled row block along the row.
        rowbytes = Px * N[None, :, None] * B                     # [P,n,X]
        t2 = (rowbytes / self.row_bw[None, None]).max(axis=-1)
        # Step 3: column redistribution from Px_i to Px_{i+1}. Row counts of
        # consecutive ops may differ (pooling/im2col); compare normalized
        # cumulative fractions and scale by op-i bytes.
        cumf = np.cumsum(Px, axis=-1) / np.maximum(M[None, :, None], 1.0)
        cumf_next = np.concatenate([cumf[:, 1:], cumf[:, -1:]], axis=1)
        crossing = (np.abs(cumf - cumf_next)[:, :, : X - 1]
                    * M[None, :, None]) if X > 1 else \
            np.zeros_like(cumf[:, :, :0])
        cross_bytes = crossing * N[None, :, None] * B
        t3 = ((cross_bytes / self.cross_bw[None, None]).max(axis=-1)
              if X > 1 else np.zeros_like(t1))
        t_redist = t1 + t2 + t3

        t_out = np.where(redist_out > 0, t_redist, t_offload)

        # Output sync for softmax/layernorm-class ops: exchange of row
        # statistics across the chiplet row (small, eq.-9 convention).
        t_sync = (self.sync[None, :]
                  * (Px.max(axis=-1) * 4.0 * B * max(Y - 1, 1))
                  / self.bw_nop_min)

        # ------------------------------------------------------- schedule
        if self.opts.async_exec:
            # Fuse comm+comp per chiplet for non-sync ops (Sec. 5.3).
            if flow_mode:
                t_fused = np.maximum(
                    (dist_done + t_comp_xy).max(axis=(-1, -2)), t_off_in)
            else:
                fused_xy = nop_in_xy + t_comp_xy
                t_fused = np.maximum(fused_xy.max(axis=(-1, -2)), t_off_in)
            core = np.where(self.sync[None, :], t_in + t_comp, t_fused)
        else:
            core = t_in + t_comp
        t_ops = core + t_out + t_sync
        latency = t_ops.sum(axis=1)

        # --------------------------------------------------------- energy
        e_sram = hw.e_sram_bit * 8.0
        e_mem = hw.e_mem_bit * 8.0
        e_nop = hw.e_nop_bit_hop * 8.0
        e_mac = hw.e_mac_cycle

        sram_bytes = (Y * inA.sum(axis=-1) + X * inW.sum(axis=-1)
                      + chunk.sum(axis=(-1, -2)))
        E_sram = e_sram * sram_bytes.sum(axis=1)

        if self.opts.energy_mode == "paper":
            # eq. 4.4.1 verbatim: c_MAC * cycles * R * C * (X*Y).
            E_mac = e_mac * (cyc.max(axis=(-1, -2)) * R * C * X * Y).sum(axis=1)
        else:
            E_mac = e_mac * (cyc.sum(axis=(-1, -2)) * R * C).sum(axis=1)

        mem_bytes = (keepA[..., None] * A_e + W_e
                     + (1.0 - redist_out)[..., None] * out_e).sum(axis=(-1, -2))
        E_mem = e_mem * mem_bytes

        # NoP bytes×hops: loads + (collection | redistribution).
        load_bh = (keepA[..., None, None] * tA_xy + tW_xy).sum(axis=(-1, -2))
        collect_bh = (chunk * self.h_min[None, None]).sum(axis=(-1, -2))
        red_bh = (
            (left_x + right_x).sum(axis=-1)            # step-1 gather
            + rowbytes.sum(axis=-1) * max(Y - 1, 1)    # step-2 broadcast
            + (cross_bytes.sum(axis=-1) * Y if X > 1 else 0.0)  # step 3
        )
        nop_bh = load_bh + np.where(redist_out > 0, red_bh, collect_bh)
        E_nop = e_nop * nop_bh.sum(axis=1)

        energy = E_sram + E_mac + E_mem + E_nop
        return {
            "latency": latency,
            "energy": energy,
            "edp": energy * latency,
            "t_in": t_in,
            "t_comp": t_comp,
            "t_out": t_out,
            "E_sram": E_sram,
            "E_mac": E_mac,
            "E_mem": E_mem,
            "E_nop": E_nop,
        }

    # -------------------------------------------------------------- helpers
    def _flow_times(self, demand: np.ndarray, chunk: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Simulate the distribution and collection phases per
        (candidate, op) on the topology's flow network (DESIGN.md §11).

        ``demand``/``chunk`` are ``[P, n, X, Y]`` byte tensors. Returns
        per-chiplet distribution completion times ``[P, n, X, Y]`` and
        collection-phase latencies ``[P, n]``. Chiplets with an empty
        mesh route (they sit on their entrance / under a 3D stack) are
        masked to zero bytes — their data never touches the NoP, and the
        off-chip terms already account for it. This is the numpy
        reference loop; the torch backend sends every simulation of a
        call to one launch of the waterfilling kernel
        (:mod:`.evaluator_torch`)."""
        from . import netsim

        caps, dinc, cinc = self.top.flow_net()
        P, n, X, Y = demand.shape
        d_routed = (dinc.sum(axis=1) > 0).reshape(X, Y)
        c_routed = (cinc.sum(axis=1) > 0).reshape(X, Y)
        demand = demand * d_routed
        chunk = chunk * c_routed
        dist_done = np.zeros((P, n, X, Y), dtype=np.float64)
        t_coll = np.zeros((P, n), dtype=np.float64)
        for p in range(P):
            for i in range(n):
                r = netsim.simulate_flows(dinc, caps, demand[p, i].ravel())
                dist_done[p, i] = r["done"].reshape(X, Y)
                rc = netsim.simulate_flows(cinc, caps, chunk[p, i].ravel())
                t_coll[p, i] = rc["latency"]
        return dist_done, t_coll

    def objective_batch(self, Px, Py, collectors, redist, objective: str
                        ) -> np.ndarray:
        out = self.evaluate_batch(Px, Py, collectors, redist)
        if objective not in out:
            raise ValueError(f"unknown objective {objective}")
        return out[objective]
