"""Training driver with fault tolerance (the port of the JAX package's
``launch/train.py``): AdamW on a cosine schedule over the synthetic
pipeline, periodic checkpoints, ``--restore auto`` to resume after a
crash or a restart.

On the card (the default), at full width and depth:
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 10 --batch 8 --seq 2048 --ckpt build/ckpt --ckpt-every 5
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 4 --batch 8 --seq 2048 --ckpt build/ckpt --restore auto
On the CPU, with the kernels' plain versions, at the reduced size:
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --reduced --steps 50 --batch 8 --seq 128 --device cpu

With ``--mesh`` the step runs over a device mesh of ``torch.distributed``
ranks, as JAX's ``--mesh``: the parameters and Adam's moments are
DTensors placed by ``sharding.partition_specs.param_placements`` (FSDP
over ``data`` × TP over ``model``), the batch is split over the data
axes, and the loop runs under ``use_rules(mesh, activation_rules(mesh,
shard_residual=not args.reduced))``. ``debug`` spans the ranks
``torchrun`` starts (gloo with ``--device cpu``, NCCL on the cards):
    torchrun --nproc-per-node=4 -m repro_torch.launch.train \
        --arch smollm-360m --reduced --steps 3 --mesh debug --device cpu
``single`` and ``multi`` are the production meshes (256 and 512 ranks),
for a real cluster. Every rank draws the same weights from ``--seed``
and keeps its shard. Without ``--mesh`` the trainer runs on one device.
The weights are masters in ``param_dtype``, the compute in ``cfg.dtype``.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..checkpoint import Checkpointer
from ..configs import PORTED, get_config
from ..data.pipeline import make_pipeline
from ..device import resolve_device
from ..models import init_model
from ..runtime import FaultTolerantLoop, StragglerMonitor
from ..train import adamw, cosine_schedule
from ..train.train_step import init_train_state, make_train_step, to_device


def build(args):
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    shape_def = dict(seq_len=args.seq, global_batch=args.batch,
                     kind="train")
    opt = adamw(lr=cosine_schedule(args.lr, args.warmup, args.steps),
                weight_decay=0.1)
    step_fn = make_train_step(cfg, opt, accum_steps=args.accum)
    pipeline = make_pipeline(cfg, shape_def, seed=args.seed)
    return cfg, opt, step_fn, pipeline


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m",
                    help=f"one of {', '.join(PORTED)}")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--dtype", default=None,
                    help="the compute dtype (default: the config's)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (a smoke run)")
    ap.add_argument("--mesh", default=None,
                    choices=[None, "debug", "single", "multi"],
                    help="run over the ranks of torch.distributed (torchrun)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--restore", default=None, choices=[None, "auto"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def _mesh(args, device):
    """(mesh, rules, device) for ``--mesh``: the process group from
    torchrun's environment (NCCL for cuda, gloo for cpu), this rank's
    card."""
    import os

    import torch.distributed as dist

    from ..sharding.partition_specs import activation_rules
    from .mesh import make_debug_mesh, make_production_mesh

    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    if args.mesh == "debug":
        mesh = make_debug_mesh()
    else:
        mesh = make_production_mesh(multi_pod=args.mesh == "multi")
    return mesh, activation_rules(mesh, shard_residual=not args.reduced), \
        device


def _place(tree: dict, placements: dict, mesh) -> dict:
    """Each rank keeps its shard of the same whole tensors."""
    from torch.distributed.tensor import distribute_tensor
    return {n: distribute_tensor(t.detach(), mesh, placements[n],
                                 src_data_rank=None)
            for n, t in tree.items()}


def _host(v) -> float:
    return float((v.full_tensor() if hasattr(v, "full_tensor") else v)
                 .float().reshape(()).item())


def main(argv=None):
    args = parse(argv)
    device = resolve_device(args.device)
    cfg, opt, step_fn, pipeline = build(args)
    mesh = rules = None
    if args.mesh:
        mesh, rules, device = _mesh(args, device)
        print(f"[train] {cfg.name} on mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} "
              f"({mesh.size()} {device.type} ranks)")
    else:
        print(f"[train] {cfg.name} on {device} (1 device)")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    model = init_model(cfg, seed=args.seed, device=device, train=True)
    params = dict(model.named_parameters())
    restore_kw = {}
    if mesh is not None:
        from ..sharding.logical import placements, sanitize_spec
        from ..sharding.partition_specs import data_specs, param_placements
        pl = param_placements(cfg, params, mesh)
        params = _place(params, pl, mesh)
        restore_kw = {"mesh": mesh, "placements": {
            "params": pl, "opt": {"m": pl, "v": pl}}}
        ds = data_specs(mesh)
    state = init_train_state(params, opt)
    del model, params

    ckpt = Checkpointer(args.ckpt) if args.ckpt else None
    start = 0
    if ckpt and args.restore == "auto" and ckpt.latest() is not None:
        state, start = ckpt.restore(device=device, **restore_kw)
        print(f"[train] restored step {start}")

    losses = []

    def run(st, batch):
        if mesh is None:
            return step_fn(st, batch)
        from torch.distributed.tensor import distribute_tensor
        from torch.distributed.tensor.experimental import \
            implicit_replication

        from ..sharding.logical import use_rules
        batch = {k: distribute_tensor(
            t, mesh, placements(sanitize_spec(ds[k], t.shape, mesh), mesh),
            src_data_rank=None)
            for k, t in to_device(batch, device).items()}
        with use_rules(mesh, rules), implicit_replication():
            return step_fn(st, batch)

    def logging_step(st, batch):
        st, metrics = run(st, batch)
        if mesh is None:
            # one transfer for every metric: the step's one host sync
            metrics = dict(zip(metrics, torch.stack(
                [v.float().reshape(()) for v in metrics.values()]).tolist()))
        else:
            metrics = {k: _host(v) for k, v in metrics.items()}
        losses.append(metrics["loss"])
        n = len(losses)
        if n % args.log_every == 0:
            print(f"  step {start + n:>5}  loss "
                  f"{np.mean(losses[-args.log_every:]):.4f}  "
                  f"gnorm {metrics['grad_norm']:.3f}")
        return st, metrics

    loop = FaultTolerantLoop(logging_step, pipeline, ckpt,
                             ckpt_every=args.ckpt_every,
                             straggler=StragglerMonitor(), device=device,
                             restore_kw=restore_kw)
    state, report = loop.run(state, start, args.steps)
    print(f"[train] done: {report.steps_run} steps, "
          f"{report.bad_steps} rejected, {report.stragglers} stragglers, "
          f"final loss {report.losses[-1]:.4f} "
          f"(first {report.losses[0]:.4f})")
    print(f"[train] losses {json.dumps(report.losses)}")
    if device.type == "cuda" and report.step_s:
        # the first step carries the kernels' build and the warm-up
        steady = report.step_s[1:] or report.step_s
        step_ms = 1e3 * float(np.median(steady))
        print(f"[train] step {step_ms:.1f} ms (median of {len(steady)}), "
              f"{args.batch * args.seq / step_ms * 1e3:.0f} tokens/s, "
              f"max_memory_allocated "
              f"{torch.cuda.max_memory_allocated(device)} B")
    return report


if __name__ == "__main__":
    main()
