"""MCMComm-driven layout planning for a grid of H100 cards (the port's
counterpart of the JAX package's ``sharding/mcm_planner.py``).

The paper's framework answers: *given a chain of GEMMs on a 2-D grid of
compute elements behind limited interconnect, how should work be
partitioned and which inter-op transfers should stay on-package?* A grid
of cards is such a grid: mesh (data × model) ↔ chiplet grid (X × Y),
NVLink ↔ NoP, each card's HBM ↔ off-chip memory (a type-C package:
memory under every chiplet), and the choice "redistribute on-package vs
round-trip through memory" ↔ "reshard activations with collectives vs
spill/gather".

This planner:
  1. extracts the per-layer GEMM sequence of an architecture config,
  2. scores layout candidates with the paper's analytical evaluator
     parameterized with H100 SXM data-sheet constants, or with a profile
     the calibration pass measured on the card,
  3. emits knobs — residual-stream sharding, microbatch accumulation
     (the Sec-5.4 pipelining analogue), redistribution mask (which
     chained pairs keep activations resident) — plus the
     *non-uniform-partition headroom* the GA finds over equal shards
     (reported, not executed).

``PlanResult.to_dryrun_knobs`` turns a plan into the dry run's knobs,
and ``launch.dryrun.execute_plan`` traces and costs it on a fake mesh, or
runs it on a real one.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.evaluator import EvalOptions, Evaluator
from ..core.ga import GAConfig, run_ga
from ..core.hw import HWConfig, MCMType
from ..core.workload import GemmOp, Task, uniform_partition

# H100 SXM data-sheet constants (per card).
H100_PEAK_FLOPS = 989e12         # bf16 dense, tensor cores
H100_HBM_BW = 3.35e12            # bytes/s, HBM3
H100_NVLINK_BW = 450e9           # bytes/s per link direction, NVLink 4
# The evaluator's systolic array (R = C): the 128 × 128 output tile of a
# Hopper GEMM block; elements are 2 bytes (bf16).
TILE = 128


def gpu_hw(mesh_shape: tuple[int, int], *, profile=None) -> HWConfig:
    """Model a grid of cards as a type-C MCM (every card has local HBM)
    with NVLink as the NoP. freq chosen so the eq.-7 systolic model
    reproduces the card's peak matmul throughput: R·C·2·freq = peak
    FLOP/s.

    With ``profile`` (a :class:`~repro_torch.kernels.calibrate.CalibratedHW`)
    the data-sheet constants are replaced by the measured ones: each card
    delivers the microbenchmarked matmul throughput and memory rate."""
    X, Y = mesh_shape
    hw = HWConfig(
        bw_nop=H100_NVLINK_BW, bw_mem=H100_HBM_BW * X * Y, X=X, Y=Y,
        R=TILE, C=TILE, mcm_type=MCMType.C,
        freq_hz=H100_PEAK_FLOPS / (2 * TILE * TILE),
        bytes_per_elem=2)
    return profile.apply(hw) if profile is not None else hw


def arch_to_task(cfg, seq_len: int, batch: int, *, layers: int | None = None
                 ) -> Task:
    """Per-layer GEMM chain of an architecture (training forward)."""
    m = seq_len * batch
    D, F = cfg.d_model, cfg.d_ff
    ops: list[GemmOp] = []
    L = layers if layers is not None else cfg.n_layers

    def block(i: int):
        p = f"l{i}."
        if cfg.attn_type == "mla":
            r_kv = cfg.kv_lora_rank
            dk = cfg.qk_nope_dim + cfg.qk_rope_dim
            ops.append(GemmOp(p + "q", M=m, K=cfg.q_lora_rank or D,
                              N=cfg.n_heads * dk, chained=bool(ops)))
            ops.append(GemmOp(p + "kv_a", M=m, K=D,
                              N=r_kv + cfg.qk_rope_dim))
            ops.append(GemmOp(p + "attn", M=m * 1, K=r_kv + cfg.qk_rope_dim,
                              N=min(seq_len, 4096),
                              n_groups=cfg.n_heads, sync=True,
                              weight_bytes_scale=float(batch)))
            ops.append(GemmOp(p + "o", M=m,
                              K=cfg.n_heads * cfg.v_head_dim, N=D))
        elif cfg.attn_type == "gqa":
            H, Dh = cfg.n_heads, cfg.d_head
            ctx = min(seq_len, cfg.window or seq_len)
            ops.append(GemmOp(p + "qkv", M=m, K=D,
                              N=(H + 2 * cfg.n_kv_heads) * Dh,
                              chained=bool(ops), sync=True))
            ops.append(GemmOp(p + "scores", M=m * H // max(H, 1), K=Dh,
                              N=ctx, n_groups=H, sync=True,
                              weight_bytes_scale=float(H * batch)))
            ops.append(GemmOp(p + "o", M=m, K=H * Dh, N=D))
        elif cfg.family == "ssm":        # rwkv6
            ops.append(GemmOp(p + "rkvgw", M=m, K=D, N=4 * D,
                              chained=bool(ops), sync=True))
            ops.append(GemmOp(p + "wkv_o", M=m, K=D, N=D, chained=True))
        if cfg.family in ("ssm", "hybrid") and cfg.ssm_state:
            di = cfg.d_inner
            ops.append(GemmOp(p + "ssm_in", M=m, K=D,
                              N=2 * di + 2 * cfg.ssm_state,
                              chained=bool(ops), sync=True))
            ops.append(GemmOp(p + "ssm_out", M=m, K=di, N=D,
                              chained=True))
        if cfg.n_experts:
            fe = cfg.moe_d_ff
            k = cfg.moe_top_k
            ops.append(GemmOp(p + "moe_up", M=m * k, K=D, N=2 * fe,
                              n_groups=cfg.n_experts, sync=True,
                              weight_bytes_scale=float(cfg.n_experts * fe)
                              / (2 * fe)))
            ops.append(GemmOp(p + "moe_down", M=m * k, K=fe, N=D,
                              chained=True,
                              weight_bytes_scale=float(cfg.n_experts)))
        elif cfg.family not in ("ssm", "hybrid"):
            ops.append(GemmOp(p + "mlp_up", M=m, K=D, N=2 * F,
                              chained=True))
            ops.append(GemmOp(p + "mlp_down", M=m, K=F, N=D,
                              chained=True))

    for i in range(L):
        block(i)
    # The vocabulary projection is real forward work — model it so
    # measured-vs-predicted comparisons share scope. It dominates shallow
    # validation slices.
    if getattr(cfg, "vocab_size", 0):
        ops.append(GemmOp("lm_head", M=m, K=D, N=cfg.vocab_size))
    return Task(f"{cfg.name}_L{L}", ops)


@dataclasses.dataclass
class PlanResult:
    arch: str
    baseline_latency: float        # LS-uniform on the cards-as-MCM model
    optimized_latency: float       # with redistribution + async overlap
    nonuniform_headroom: float     # extra gain GA finds with non-uniform
    redist_mask: np.ndarray
    knobs: dict

    @property
    def modeled_speedup(self) -> float:
        return self.baseline_latency / self.optimized_latency

    def to_dryrun_knobs(self) -> dict:
        """The executable subset of the plan, as ``launch/dryrun``
        ``lower_cell``/``run_cell`` keyword knobs: what
        :func:`repro_torch.launch.dryrun.execute_plan` runs."""
        return {"shard_residual": bool(self.knobs["shard_residual"]),
                "accum": int(self.knobs["accum_steps"])}


def plan(cfg, mesh_shape: tuple[int, int], seq_len: int, batch: int,
         *, layers: int = 2, ga_budget: int = 30,
         profile=None) -> PlanResult:
    """Score layouts for one arch on one grid of cards and emit runtime
    knobs. ``profile`` swaps the data-sheet constants for a measured
    :class:`~repro_torch.kernels.calibrate.CalibratedHW`."""
    hw = gpu_hw(mesh_shape, profile=profile)
    task = arch_to_task(cfg, seq_len, max(batch // (mesh_shape[0]
                                                    * mesh_shape[1]), 1)
                        * mesh_shape[0] * mesh_shape[1], layers=layers)
    part = uniform_partition(task, hw.X, hw.Y)
    # Baseline AND optimized both keep chained activations on-fabric
    # (redistribution) — a grid of cards has no shared off-chip pool to
    # round-trip through. Optimized adds async comm/comp fusion (Sec 5.3).
    base_ev = Evaluator(task, hw, EvalOptions(redistribution=True))
    rd_all = base_ev.chain_valid.copy()
    base = base_ev.evaluate(part, rd_all).latency

    opt_ev = Evaluator(task, hw,
                       EvalOptions(redistribution=True, async_exec=True))
    optimized = opt_ev.evaluate(part, rd_all).latency

    # Cards share no memory: chained activations move over NVLink
    # regardless, so redistribution stays frozen on and the GA explores
    # partitions/collectors only. Its extra gain over the uniform plan is
    # the non-uniform headroom that equal shards cannot realize
    # (reported, not executed).
    ga = run_ga(task, hw, "latency",
                EvalOptions(redistribution=True, async_exec=True),
                GAConfig(generations=ga_budget, population=32, seed=0,
                         freeze_redist=True))
    # The planner only adopts the GA plan when it beats the uniform one,
    # so the reported headroom is ≥ 1 by construction (a GA run that
    # loses to uniform is no headroom, not negative headroom).
    headroom = (optimized / ga.objective
                if 0 < ga.objective < optimized else 1.0)

    knobs = {
        # keeping chained activations resident ↔ shard the residual stream
        # so no per-layer gather/spill of the full hidden state is needed
        "shard_residual": bool(rd_all.any()),
        # the Sec-5.4 cross-sample pipelining analogue: microbatching that
        # overlaps grad collectives with the next microbatch —
        # largest step count ≤ 4 that divides the global batch, so the
        # microbatch split is always executable
        "accum_steps": max(a for a in (4, 2, 1) if batch % a == 0),
        "redist_mask": rd_all,
    }
    return PlanResult(cfg.name, base, optimized, headroom, rd_all, knobs)
