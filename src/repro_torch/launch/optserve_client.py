"""Optimization-server client walkthrough (DESIGN.md §14), the port's
counterpart of the JAX package's ``examples/optserve_client.py``: submit
mixed co-optimization traffic (evaluations under ``regime`` and ``flow``
congestion, a GA solve, pipelining) to an in-process ``OptServer`` whose
torch backend runs on the device, stream the futures back, then restart
against the same store to serve the same requests warm, through the
asyncio submission path.

On the card (the default):
    PYTHONPATH=src python -m repro_torch.launch.optserve_client
On the CPU:
    PYTHONPATH=src python -m repro_torch.launch.optserve_client \
        --device cpu

The store is a file in a temporary directory, as the example's is.
"""
from __future__ import annotations

import argparse
import asyncio
import os
import tempfile

from ..core import EvalOptions, make_hw, sweep
from ..core.ga import GAConfig
from ..core.workload import uniform_partition
from ..device import resolve_device
from ..graphs import alexnet_task, vit_task
from ..serve import OptRequest, OptServer


def build_requests() -> list[OptRequest]:
    """The example's traffic: AlexNet and ViT evaluated on a 4x4 type-A
    HBM package under both congestion models, a GA solve, a pipeline."""
    hw = make_hw("A", grid=4, memory="hbm")
    reqs = []
    for task in (alexnet_task(batch=1), vit_task(batch=1)):
        part = uniform_partition(task, hw.X, hw.Y)
        for cong in ("regime", "flow"):
            reqs.append(OptRequest(
                "eval",
                sweep.EvalPoint(task, hw, EvalOptions(congestion=cong),
                                part)))
    reqs.append(OptRequest(
        "solve", sweep.EvalPoint(alexnet_task(batch=1), hw),
        objective="latency", method="ga",
        cfg=GAConfig(generations=10, population=32, seed=0)))
    reqs.append(OptRequest(
        "pipeline",
        sweep.PipelinePoint([("conv", 0.4, 1.2, 0.4),
                             ("mlp", 0.2, 0.9, 0.3),
                             ("head", 0.1, 0.5, 0.2)], batch=8)))
    return reqs


def show(req: OptRequest, res) -> str:
    if req.kind == "eval":
        return (f"  eval     {req.point.task.name:<10} "
                f"congestion={req.point.options.congestion:<7} "
                f"latency={res['latency'] * 1e6:9.1f} us")
    if req.kind == "solve":
        return (f"  solve/ga {req.point.task.name:<10} "
                f"objective={res.objective:.4e} "
                f"({res.evaluations} evaluations)")
    return (f"  pipeline batch={res.batch} "
            f"sequential={res.sequential:.2f} "
            f"pipelined={res.pipelined:.2f} "
            f"({res.sequential / res.pipelined:.2f}x)")


def run(store: str, device, log=print) -> dict:
    """The walkthrough against ``store`` → {"cold", "warm": results in
    request order, "cold_stats", "warm_stats": ``OptServer.stats()``,
    "loaded": entries the restarted server read from the store}."""
    reqs = build_requests()

    # cold server: everything is computed, coalesced by CallKey
    srv = OptServer(store_path=store, device=device)
    futs = [srv.submit(r) for r in reqs]        # returns immediately
    cold = [f.result() for f in futs]
    for r, res in zip(reqs, cold):
        log(show(r, res))
    cold_stats = srv.stats()
    log(f"cold:  {cold_stats['completed']} requests, "
        f"coalesce {cold_stats['coalesce_factor']:.1f}x over "
        f"{cold_stats['batches']} sweep calls, cache hit-rate "
        f"{cold_stats['cache_hit_rate'] * 100:.0f}%")
    srv.close()                                 # full-save (atomic) store

    # warm restart: the same requests served from the persisted cache
    sweep.clear_cache()                         # as a new process
    srv = OptServer(store_path=store, device=device)
    loaded = srv.store_info["loaded"]
    log(f"store: restored {loaded} entries")

    async def client():
        return await asyncio.gather(
            *(srv.submit_async(r) for r in build_requests()))

    warm = asyncio.run(client())
    warm_stats = srv.stats()
    log(f"warm:  {warm_stats['completed']} requests, cache hit-rate "
        f"{warm_stats['cache_hit_rate'] * 100:.0f}%, p99 "
        f"{warm_stats['p99_ms']:.1f}ms")
    srv.close()
    return {"cold": cold, "warm": list(warm), "cold_stats": cold_stats,
            "warm_stats": warm_stats, "loaded": loaded}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix="optserve-") as tmp:
        return run(os.path.join(tmp, "cache.bin"), device)


if __name__ == "__main__":
    main()
