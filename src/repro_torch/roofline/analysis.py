"""Three-term roofline analysis over the dry run's records (the port of
the JAX package's ``roofline/analysis.py``).

    compute term    = FLOPs_global / (chips × peak_FLOP/s)
    memory term     = HBM_bytes_global / (chips × HBM_bw)
    collective term = collective_bytes_global / (chips × link_bw)

The port's dry run (``launch.dryrun``) counts FLOPs, bytes and collective
bytes *per device* on the local shards, so the global quantities are
(per-device × chips) and each term reduces to per_device_quantity /
per_chip_peak.

The constants are an H100 SXM's (989 TFLOP/s bf16 dense, 3.35 TB/s HBM3,
NVLink 4 at 450 GB/s a direction, the port's ``kernels/calibrate.py``
and ``sharding/mcm_planner.py``); every function takes them as
arguments, so JAX's TPU v5e constants reproduce its numbers. Where the
JAX text says "HLO" the port's record holds the trace's counts.

MODEL_FLOPS uses 6·N·D for training (N params, D tokens; N_active for
MoE) and 2·N·D for inference; the ratio MODEL_FLOPS / HLO_FLOPs exposes
remat/redundancy waste (>1/3 of compiled compute being recompute is the
remat signature).
"""
from __future__ import annotations

import dataclasses
import json
import os

from ..configs import SHAPE_DEFS, get_config
from ..sharding.mcm_planner import (H100_HBM_BW, H100_NVLINK_BW,
                                    H100_PEAK_FLOPS)

# H100 SXM per-card constants (data sheet).
PEAK_FLOPS = H100_PEAK_FLOPS    # bf16 dense, tensor cores
HBM_BW = H100_HBM_BW            # bytes/s, HBM3
LINK_BW = H100_NVLINK_BW        # bytes/s, NVLink 4, one direction


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    kind: str
    compute_s: float
    memory_s: float          # fusion-aware analytic HBM estimate
    collective_s: float
    model_flops: float
    hlo_flops_global: float
    per_device_hbm_bytes: float
    collective_breakdown: dict
    hlo_bytes_s: float = 0.0  # raw (unfused) byte term — upper bound
    peak_flops: float = PEAK_FLOPS

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        """Roofline-model step time = max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / global HLO FLOPs (≤1 without remat; <1 means the
        compiled graph burns FLOPs on recompute/redundancy; >1 flags an
        HLO count that misses fused ops)."""
        return (self.model_flops / self.hlo_flops_global
                if self.hlo_flops_global > 0 else 0.0)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the chips' peak compute the bound-time achieves on
        *useful* (model) FLOPs — the score §Perf drives up."""
        t = self.bound_time
        if t <= 0:
            return 0.0
        n_chips = {"single_pod_16x16": 256, "multi_pod_2x16x16": 512}[
            self.mesh]
        return self.model_flops / t / (n_chips * self.peak_flops)


def analytic_hbm_bytes(arch: str, shape: str) -> float:
    """Fusion-aware per-device HBM traffic estimate (bytes/step).

    The trace's ``bytes_per_device`` counts every op's operand/result
    bytes with no fusion model, a 10–100× overestimate of real HBM
    traffic. This estimate (JAX's) counts what *must* cross HBM:

      train   : gathered-param reads per microbatch (fwd+bwd) over the
                TP shard, Adam state read+write, saved layer-boundary
                activations (write in fwd, read in bwd), token I/O
      prefill : one gathered-param read + KV-cache writes + boundary
                activations
      decode  : one gathered-param read (per-token weight streaming — the
                canonical decode bottleneck) + full cache read + write
    """
    from ..launch.policies import TRAIN_ACCUM, TRAIN_LOWMEM

    cfg = get_config(arch)
    sd = SHAPE_DEFS[shape]
    S, B = sd["seq_len"], sd["global_batch"]
    kind = sd["kind"]
    n_chips, tp, dp = 256, 16, 16

    P = float(cfg.param_count())
    act_p = _active_params(cfg)           # per-token touched params
    pb = 2.0                              # bf16 compute reads
    # gathered (full along data/FSDP axis) parameter bytes per TP shard;
    # MoE: only active experts' weights are read per token group, but
    # capacity-based dense dispatch touches all local experts — use full P
    param_read = P * pb / tp

    # serving state bytes per device
    cache_bytes = _cache_bytes(cfg, B, S) / n_chips

    if kind == "train":
        accum = TRAIN_ACCUM.get(arch, 1)
        opt_b = (2 + 2) if arch in TRAIN_LOWMEM else (4 + 4)
        pdtype = 2 if cfg.param_dtype == "bfloat16" else 4
        adam = P / n_chips * (2 * opt_b + 2 * pdtype + 2 * pb)  # m,v,p rw + grad rw
        tokens_dev = S * B / dp           # batch sharded over data axis
        # saved residuals: one (tokens, d_model) bf16 per layer, written
        # fwd + read bwd; sharded over model when shard_residual
        res_shard = tp if cfg.d_model >= 2048 else 1
        acts = (tokens_dev * cfg.d_model * 2.0 * cfg.n_layers * 2.0
                / res_shard)
        io = tokens_dev * 4.0 * 2
        return 2.0 * accum * param_read + adam + acts + io
    if kind == "prefill":
        tokens_dev = S * B / dp
        acts = tokens_dev * cfg.d_model * 2.0 * cfg.n_layers / tp
        return param_read + cache_bytes + acts
    # decode: stream weights once, read the whole cache, write one slot
    return param_read + cache_bytes


def _cache_bytes(cfg, batch: int, seq: int) -> float:
    """Total serving-state bytes across the pod for one model."""
    L = cfg.n_layers
    if cfg.family == "ssm":     # rwkv6
        H, K = cfg.rwkv_heads, cfg.rwkv_head_dim
        return L * batch * (H * K * K * 4.0 + 2 * cfg.d_model * 2.0)
    if cfg.family == "hybrid":
        di, H = cfg.d_inner, cfg.ssm_heads
        mamba = L * batch * (H * cfg.ssm_head_dim * cfg.ssm_state * 4.0
                             + (cfg.ssm_conv - 1)
                             * (di + 2 * cfg.ssm_state) * 2.0)
        n_groups = L // max(cfg.hybrid_attn_period, 1)
        win = min(seq, cfg.window or seq)
        attn = n_groups * batch * win * cfg.n_kv_heads * cfg.d_head \
            * 2 * 2.0
        return mamba + attn
    if cfg.attn_type == "mla":
        return L * batch * min(seq, 10**9) * (cfg.kv_lora_rank
                                              + cfg.qk_rope_dim) * 2.0
    win = min(seq, cfg.window or seq) if cfg.local_global_period == 0 \
        else seq  # gemma2: half local(window) + half global(full) ≈ avg
    if cfg.local_global_period:
        win = (min(seq, cfg.window) + seq) / 2
    return L * batch * win * cfg.n_kv_heads * cfg.d_head * 2 * 2.0


def _active_params(cfg) -> float:
    """Per-token active parameter count (MoE: top-k + shared experts)."""
    total = cfg.param_count()
    if not cfg.n_experts:
        return float(total)
    expert = 3 * cfg.d_model * cfg.moe_d_ff
    routed_all = cfg.n_experts * expert * (cfg.n_layers
                                           - cfg.first_dense_layers)
    active = (cfg.moe_top_k + cfg.n_shared_experts) * expert * (
        cfg.n_layers - cfg.first_dense_layers)
    return float(total - routed_all + active)


def model_flops_for(arch: str, shape: str) -> float:
    cfg = get_config(arch)
    sd = SHAPE_DEFS[shape]
    n_active = _active_params(cfg)
    if sd["kind"] == "train":
        tokens = sd["seq_len"] * sd["global_batch"]
        return 6.0 * n_active * tokens
    if sd["kind"] == "prefill":
        tokens = sd["seq_len"] * sd["global_batch"]
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * sd["global_batch"]


def analyze_record(rec: dict, *, peak_flops: float = PEAK_FLOPS,
                   hbm_bw: float = HBM_BW,
                   link_bw: float = LINK_BW) -> RooflineTerms:
    n_dev = rec["n_devices"]
    src = rec.get("calibrated", rec)  # prefer loop-corrected quantities
    flops_dev = max(src["flops_per_device"], 0.0)
    bytes_dev = max(src["bytes_per_device"], 0.0)
    coll = src.get("collective_bytes_per_device", {})
    coll_dev = float(sum(coll.values()))
    hbm_dev = analytic_hbm_bytes(rec["arch"], rec["shape"])
    return RooflineTerms(
        arch=rec["arch"],
        shape=rec["shape"],
        mesh=rec["mesh"],
        kind=rec["kind"],
        compute_s=flops_dev / peak_flops,
        memory_s=hbm_dev / hbm_bw,
        collective_s=coll_dev / link_bw,
        model_flops=model_flops_for(rec["arch"], rec["shape"]),
        hlo_flops_global=flops_dev * n_dev,
        per_device_hbm_bytes=hbm_dev,
        collective_breakdown=coll,
        hlo_bytes_s=bytes_dev / hbm_bw,
        peak_flops=peak_flops,
    )


def load_records(art_dir: str, mesh: str = "single_pod_16x16"
                 ) -> list[dict]:
    d = os.path.join(art_dir, mesh)
    out = []
    if not os.path.isdir(d):
        return out
    for f in sorted(os.listdir(d)):
        if f.endswith(".json"):
            with open(os.path.join(d, f)) as fh:
                out.append(json.load(fh))
    return out


def format_table(terms: list[RooflineTerms]) -> str:
    hdr = (f"{'arch':<18} {'shape':<12} {'comp_ms':>9} {'mem_ms':>9} "
           f"{'coll_ms':>9} {'bound':<10} {'useful':>7} {'roofline':>9}")
    rows = [hdr, "-" * len(hdr)]
    for t in terms:
        rows.append(
            f"{t.arch:<18} {t.shape:<12} {t.compute_s*1e3:>9.2f} "
            f"{t.memory_s*1e3:>9.2f} {t.collective_s*1e3:>9.2f} "
            f"{t.dominant:<10} {t.useful_ratio:>7.2f} "
            f"{t.roofline_fraction*100:>8.1f}%")
    return "\n".join(rows)
