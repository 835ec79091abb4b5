"""The calibration pass: time the port's four kernel families on the
device and fit the analytical evaluator's constants into a versioned
:class:`CalibratedHW` profile (the port's counterpart of the JAX
package's ``kernels/calibrate.py``).

``profile_kernels`` runs each family through the port's public ops, the
hand-written CUDA kernels on the card and their plain versions on the
CPU: ``gemm.ops.matmul``, ``flash_attention.ops.attention`` (causal),
``rwkv6.ops.wkv6`` and ``ssm_scan.ops.ssm_scan``, at the JAX pass's
sizes, on the same f32 inputs drawn from ``np.random.default_rng(seed)``
in the same order (seed 0 by default, as in the JAX pass). Each sample is timed
as the JAX pass times it: one untimed call first (on the card it also
builds the kernel at first use), then the median of ``reps`` calls,
each between two CUDA events on the card and by ``time.perf_counter`` on
the CPU. So a full pass launches each kernel ``samples × (1 + reps)``
times. The profile is persisted with the port's ``serve/cache_store``
record framing (magic + schema header, CRC-framed records, atomic save),
so a stale or corrupt profile degrades to a re-calibration, never a
crash.

Fitting contract (the JAX pass's formulas):

``flops_per_s``   achieved matmul throughput (gemm samples only — the
                  eq.-7 systolic model is a matmul model). Applied as
                  ``freq_hz = flops_per_s / (2·R·C)`` so R·C·2·freq
                  reproduces the measured rate.
``bytes_per_s``   best achieved byte rate over all samples.
``byte_overhead`` 1: moved bytes per ideal byte (see below); the
                  evaluator's memory bandwidth is
                  ``bytes_per_s / byte_overhead``.
``nop_frac``      NoP-link : memory bandwidth ratio. One card exposes no
                  link to measure, so the architectural ratio is kept
                  from the H100 SXM data sheet (NVLink 4 at 450 GB/s each
                  way over HBM3 at 3.35 TB/s) rather than fitted.

What differs from the JAX pass, and why:

* There is no ``calibration()`` context, ``scan_unroll()`` or
  ``_cost_dict``. They repair XLA's ``cost_analysis`` counting a
  ``while`` body once, not per trip. The port's dry run
  (``launch.dryrun``) counts the ops of the step it runs, every trip of
  every loop (layers, chunks, microbatches) included, so its counts need
  no repair; ``dryrun.calibrate_cell`` keeps JAX's per-unit
  extrapolation, which equals the full-depth trace.
* Counts are analytic. A gemm sample's ``flops`` is 2·M·K·N, which is
  what XLA reports for the JAX ``matmul_ref``. The other samples count
  the matrix products of their plain chunked form; their FLOPs do not
  enter the fit.
* A sample moves its ideal bytes (each input read once, the output
  written once), because each kernel keeps its intermediates out of
  device memory. So a sample has no moved-bytes count and
  ``byte_overhead`` is 1 by construction, where the JAX pass takes the
  median of XLA's byte count of the unfused graph over the ideal bytes.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
import time

import numpy as np
import torch

from ..device import resolve_device

# Profile schema — bump when CalibratedHW fields change meaning; old
# profiles then miss on the versioned key and trigger re-calibration.
PROFILE_SCHEMA = 1

# H100 SXM data sheet: NVLink 4 at 450 GB/s each way, HBM3 at 3.35 TB/s —
# the architectural ratio used for bw_nop, since one card has no
# interconnect to measure.
NVLINK_OVER_HBM = 450e9 / 3.35e12


# --------------------------------------------------------------------------
# Measured samples and the fitted profile
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KernelSample:
    """One microbenchmark point: analytic counts + device time."""
    kernel: str                # gemm | flash_attention | rwkv6 | ssm_scan
    shape: tuple               # human-readable problem dims
    flops: float               # analytic operation count
    ideal_bytes: float         # operand+result elements × dtype size
    wall_s: float              # median time of one call
    reps: int = 1

    @property
    def achieved_flops_per_s(self) -> float:
        return self.flops / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def achieved_bytes_per_s(self) -> float:
        return self.ideal_bytes / self.wall_s if self.wall_s > 0 else 0.0


@dataclasses.dataclass(frozen=True)
class CalibratedHW:
    """Fitted evaluator constants for one device type (see module
    docstring)."""
    backend: str               # the device type: "cuda" or "cpu"
    flops_per_s: float         # per model chip, matmul-achieved
    bytes_per_s: float         # per model chip
    byte_overhead: float       # moved bytes per ideal byte (≥ 1)
    nop_frac: float = NVLINK_OVER_HBM
    schema: int = PROFILE_SCHEMA
    samples: tuple = ()

    def freq_for(self, R: int, C: int) -> float:
        """Systolic clock reproducing the measured matmul peak: the eq.-7
        model delivers R·C·2·freq FLOP/s per chiplet."""
        return self.flops_per_s / (2.0 * R * C)

    @property
    def bw_mem_model(self) -> float:
        """Effective memory bandwidth on the evaluator's ideal-byte basis."""
        return self.bytes_per_s / max(self.byte_overhead, 1.0)

    @property
    def bw_nop_model(self) -> float:
        """Per-link NoP bandwidth: architectural ratio × measured memory."""
        return self.bw_mem_model * self.nop_frac

    def apply(self, hw):
        """Rescale a :class:`~repro_torch.core.hw.HWConfig` onto the
        measured constants: every chiplet owns one calibrated memory port
        (the type-C mapping of ``sharding/mcm_planner``)."""
        n_chips = hw.X * hw.Y
        return hw.replace(
            freq_hz=self.freq_for(hw.R, hw.C),
            bw_mem=self.bw_mem_model * n_chips,
            bw_nop=self.bw_nop_model)


def fit_profile(samples, backend: str) -> CalibratedHW:
    """The fitting contract of the module docstring over ``samples``."""
    samples = tuple(samples)
    gemm = [s for s in samples if s.kernel == "gemm"]
    flops_per_s = max(s.achieved_flops_per_s for s in gemm)
    bytes_per_s = max(s.achieved_bytes_per_s for s in samples)
    return CalibratedHW(
        backend=backend,
        flops_per_s=flops_per_s,
        bytes_per_s=bytes_per_s,
        byte_overhead=1.0,      # each kernel moves its ideal bytes
        samples=samples)


# --------------------------------------------------------------------------
# Microbenchmarks: the port's ops (the CUDA kernels on the card)
# --------------------------------------------------------------------------

def _measure(fn, args, *, reps: int, device: torch.device) -> float:
    """Median seconds of one ``fn(*args)`` call over ``reps`` calls,
    after one untimed call."""
    fn(*args)
    walls = []
    if device.type == "cuda":
        with torch.cuda.device(device):
            torch.cuda.synchronize()
            for _ in range(max(reps, 1)):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args)
                end.record()
                end.synchronize()
                walls.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(max(reps, 1)):
            t0 = time.perf_counter()
            fn(*args)
            walls.append(time.perf_counter() - t0)
    return statistics.median(walls)


def _nbytes(*tensors) -> float:
    return float(sum(t.numel() * t.element_size() for t in tensors))


def _f32(array, device) -> torch.Tensor:
    return torch.as_tensor(array, dtype=torch.float32, device=device)


def _bench_gemm(rng, sizes, reps, device) -> list[KernelSample]:
    from .gemm.ops import matmul

    out = []
    for m, k, n in sizes:
        a = _f32(rng.standard_normal((m, k)), device)
        b = _f32(rng.standard_normal((k, n)), device)
        w = _measure(matmul, (a, b), reps=reps, device=device)
        ideal = _nbytes(a, b) + 4.0 * m * n
        out.append(KernelSample("gemm", (m, k, n), 2.0 * m * k * n, ideal,
                                w, reps))
    return out


def _bench_attention(rng, sizes, reps, device) -> list[KernelSample]:
    from .flash_attention.ops import attention

    out = []
    for bsz, s, h, dh in sizes:
        q = _f32(rng.standard_normal((bsz, s, h, dh)), device)
        k = _f32(rng.standard_normal((bsz, s, h, dh)), device)
        v = _f32(rng.standard_normal((bsz, s, h, dh)), device)
        fn = lambda q, k, v: attention(q, k, v, causal=True)
        w = _measure(fn, (q, k, v), reps=reps, device=device)
        ideal = _nbytes(q, k, v) * 4.0 / 3.0    # q,k,v + same-shaped out
        # the plain blockwise form's QKᵀ and PV over every (query, key)
        # pair: it skips no masked block
        flops = 2.0 * bsz * h * s * s * 2 * dh
        out.append(KernelSample("flash_attention", (bsz, s, h, dh), flops,
                                ideal, w, reps))
    return out


def _bench_rwkv6(rng, sizes, reps, device) -> list[KernelSample]:
    from .rwkv6.ops import wkv6

    out = []
    for bsz, s, h, k, chunk in sizes:
        shp = (bsz, s, h, k)
        r = _f32(rng.standard_normal(shp), device)
        kk = _f32(rng.standard_normal(shp), device)
        v = _f32(rng.standard_normal(shp), device)
        w = _f32(rng.uniform(0.6, 0.99, shp), device)
        u = _f32(rng.standard_normal((h, k)), device)
        fn = lambda r, kk, v, w, u: wkv6(r, kk, v, w, u, chunk=chunk)[0]
        wall = _measure(fn, (r, kk, v, w, u), reps=reps, device=device)
        ideal = _nbytes(r, kk, v, w, u) + _nbytes(r)   # out ~ r-shaped
        # the chunked form, per (b, h, chunk of Lc): r·k·decay (Lc·Lc·K),
        # its product with v (Lc·Lc·K), r·S and kᵀ·v (Lc·K·K each)
        lc = min(chunk, s)
        flops = 4.0 * bsz * h * math.ceil(s / lc) * lc * k * (lc + k)
        out.append(KernelSample("rwkv6", (bsz, s, h, k, chunk), flops,
                                ideal, wall, reps))
    return out


def _bench_ssm_scan(rng, sizes, reps, device) -> list[KernelSample]:
    from .ssm_scan.ops import ssm_scan

    out = []
    for bsz, s, h, p, g, n, chunk in sizes:
        x = _f32(rng.standard_normal((bsz, s, h, p)), device)
        dt = _f32(rng.uniform(0.001, 0.1, (bsz, s, h)), device)
        a = _f32(-rng.uniform(0.5, 2.0, (h,)), device)
        B = _f32(rng.standard_normal((bsz, s, g, n)), device)
        C = _f32(rng.standard_normal((bsz, s, g, n)), device)
        D = _f32(rng.standard_normal((h,)), device)
        fn = lambda x, dt, a, B, C, D: ssm_scan(x, dt, a, B, C, D,
                                                chunk=chunk)[0]
        wall = _measure(fn, (x, dt, a, B, C, D), reps=reps, device=device)
        ideal = _nbytes(x, dt, a, B, C, D) + _nbytes(x)
        # the chunked form, per (b, chunk of Lc): C·Bᵀ per group
        # (Lc·Lc·N) and, per head, its product with x (Lc·Lc·P), C·h and
        # the state update (N·P·Lc each)
        lc = min(chunk, s)
        flops = (2.0 * bsz * math.ceil(s / lc) * lc
                 * (g * lc * n + h * (lc * p + 2 * n * p)))
        out.append(KernelSample("ssm_scan", (bsz, s, h, p, g, n, chunk),
                                flops, ideal, wall, reps))
    return out


def profile_kernels(*, smoke: bool = False, reps: int = 3, seed: int = 0,
                    device=None) -> CalibratedHW:
    """Run the kernel microbenchmarks and fit a :class:`CalibratedHW`.
    ``seed`` draws the inputs, as the JAX pass's does. ``device=None``
    means the card (raises without one); ``"cpu"`` runs the plain
    versions."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    if smoke:
        gemm_sizes = [(128, 128, 128), (256, 256, 256)]
        attn_sizes = [(1, 128, 2, 32)]
        rwkv_sizes = [(1, 64, 1, 16, 16)]
        ssm_sizes = [(1, 128, 1, 8, 1, 8, 32)]
    else:
        gemm_sizes = [(256, 256, 256), (512, 512, 512), (768, 768, 768)]
        attn_sizes = [(1, 256, 4, 64), (2, 512, 4, 64)]
        rwkv_sizes = [(1, 128, 2, 32, 32), (2, 256, 2, 32, 32)]
        ssm_sizes = [(1, 256, 2, 16, 1, 16, 64), (2, 512, 2, 16, 1, 16, 64)]

    samples: list[KernelSample] = []
    samples += _bench_gemm(rng, gemm_sizes, reps, device)
    samples += _bench_attention(rng, attn_sizes, reps, device)
    samples += _bench_rwkv6(rng, rwkv_sizes, reps, device)
    samples += _bench_ssm_scan(rng, ssm_sizes, reps, device)
    return fit_profile(samples, device.type)


# --------------------------------------------------------------------------
# Persistence — serve/cache_store record idiom (versioned key; corrupt or
# stale files degrade to a miss, never a crash)
# --------------------------------------------------------------------------

_PROFILE_KEY = ("calibrated_hw", PROFILE_SCHEMA)


def save_profile(profile: CalibratedHW, path: str) -> int:
    from ..serve.cache_store import CacheStore
    return CacheStore(path).save({_PROFILE_KEY: profile})


def load_profile(path: str) -> CalibratedHW | None:
    from ..serve.cache_store import CacheStore
    prof = CacheStore(path).load().get(_PROFILE_KEY)
    if isinstance(prof, CalibratedHW) and prof.schema == PROFILE_SCHEMA:
        return prof
    return None
