"""The planner over the model zoo from the command line: treat a 16x16
grid of cards as the paper's MCM grid and score layout choices for every
architecture with the analytical framework (``sharding.mcm_planner``),
the port's counterpart of the JAX package's ``examples/mcm_plan_tpu.py``
(seq 4096, batch 256, 2 layers, a GA budget of 10 generations; the same
columns).

The planner itself runs on the host (the numpy evaluator and GA). The
device calibrates it: ``kernels.calibrate.profile_kernels`` times the
port's kernels there, and the plans use the fitted rates.

On the card (the default):
    PYTHONPATH=src python -m repro_torch.launch.plan_mesh
On the CPU (the kernels' plain versions calibrate):
    PYTHONPATH=src python -m repro_torch.launch.plan_mesh --device cpu
"""
from __future__ import annotations

import argparse

from ..configs import ARCHS, get_config
from ..device import resolve_device
from ..kernels.calibrate import profile_kernels
from ..sharding.mcm_planner import plan

# The example's settings: a 16x16 grid, seq 4096, batch 256, 2 layers,
# a GA budget of 10 generations.
MESH, SEQ, BATCH, LAYERS, GA_BUDGET = (16, 16), 4096, 256, 2, 10

HEADER = (f"{'arch':<18} {'base_ms':>9} {'opt_ms':>9} {'overlap':>8} "
          f"{'nonuniform_headroom':>20}")


def plan_zoo(archs=ARCHS, profile=None) -> dict:
    """{arch: ``PlanResult``} of ``plan`` for each arch at the example's
    settings; ``profile`` a ``CalibratedHW`` (None: the data sheet)."""
    return {arch: plan(get_config(arch), MESH, SEQ, BATCH, layers=LAYERS,
                       ga_budget=GA_BUDGET, profile=profile)
            for arch in archs}


def row(arch: str, r) -> str:
    return (f"{arch:<18} {r.baseline_latency * 1e3:>9.3f} "
            f"{r.optimized_latency * 1e3:>9.3f} "
            f"{r.modeled_speedup:>7.2f}x "
            f"{r.nonuniform_headroom:>19.2f}x")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    profile = profile_kernels(device=device)
    print(f"calibrated on {device}: {profile.flops_per_s:.3e} FLOP/s, "
          f"{profile.bytes_per_s:.3e} B/s")
    results = plan_zoo(profile=profile)
    print(HEADER)
    for arch, r in results.items():
        print(row(arch, r))
    print("\n(headroom = extra gain from non-uniform partitions the")
    print(" paper's GA finds but equal-shard SPMD cannot realize)")
    return results


if __name__ == "__main__":
    main()
