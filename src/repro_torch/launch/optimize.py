"""The paper's front door from the command line: schedule one workload on
one MCM with the four Table-3 schemes and score each against the LS
baseline (the port's counterpart of the JAX package's
``examples/quickstart.py``).

On the card (the default: the MIQP lattice scores its chunks there):
    PYTHONPATH=src python -m repro_torch.launch.optimize --task vit
On the CPU (the torch evaluator on the host):
    PYTHONPATH=src python -m repro_torch.launch.optimize --task vit \
        --device cpu
"""
from __future__ import annotations

import argparse

from ..core import api
from ..core.hw import make_hw
from ..core.miqp import MIQPConfig
from ..device import resolve_device
from ..graphs import WORKLOADS


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="vit", choices=sorted(WORKLOADS))
    ap.add_argument("--type", default="A", choices=("A", "B", "C", "D"),
                    help="MCM packaging type")
    ap.add_argument("--grid", type=int, default=4,
                    help="chiplets per side")
    ap.add_argument("--memory", default="hbm", choices=("hbm", "dram"))
    ap.add_argument("--objective", default="latency",
                    choices=("latency", "edp"))
    ap.add_argument("--batch", type=int, default=8,
                    help="samples for the cross-sample pipelining line")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    task = WORKLOADS[args.task](batch=1)
    hw = make_hw(args.type, grid=args.grid, memory=args.memory)
    print(hw.topology.describe())
    print(f"\nworkload: {task.name}, {len(task)} GEMMs, "
          f"{task.total_flops/1e9:.1f} GFLOPs; torch evaluator on {device}")

    results = {}
    for method in api.METHODS:
        r = api.optimize(task, hw, method, args.objective,
                         miqp_config=MIQPConfig(time_limit=30),
                         device=device)
        results[method] = r
        print(f"  {method:<9} latency={r.latency*1e6:9.1f} us  "
              f"EDP={r.edp:.3e}  speedup={r.speedup_vs_baseline:5.2f}x  "
              f"(solve {r.solve_seconds:.1f}s)")
    pipe = results["miqp"].pipeline(batch=args.batch)
    print(f"\nmiqp with cross-sample pipelining (batch {args.batch}): "
          f"{pipe.speedup:.2f}x additional throughput")
    return results


if __name__ == "__main__":
    main()
