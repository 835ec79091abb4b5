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

There is no ``--mesh``: the port trains on one device. The weights are
f32 masters (``param_dtype``), the compute in ``cfg.dtype``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..checkpoint import Checkpointer
from ..configs import PORTED, get_config
from ..data.pipeline import make_pipeline
from ..device import resolve_device
from ..models import init_model
from ..runtime import FaultTolerantLoop, StragglerMonitor
from ..train import adamw, cosine_schedule
from ..train.train_step import init_train_state, make_train_step


def build(args):
    cfg = get_config(args.arch, reduced=args.reduced)
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


def main(argv=None):
    args = parse(argv)
    device = resolve_device(args.device)
    cfg, opt, step_fn, pipeline = build(args)
    print(f"[train] {cfg.name} on {device} (1 device)")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    model = init_model(cfg, seed=args.seed, device=device, train=True)
    state = init_train_state(dict(model.named_parameters()), opt)
    del model

    ckpt = Checkpointer(args.ckpt) if args.ckpt else None
    start = 0
    if ckpt and args.restore == "auto" and ckpt.latest() is not None:
        state, start = ckpt.restore(device=device)
        print(f"[train] restored step {start}")

    losses = []

    def logging_step(st, batch):
        st, metrics = step_fn(st, batch)
        # one transfer for every metric: the step's one host sync
        metrics = dict(zip(metrics, torch.stack(
            [v.float().reshape(()) for v in metrics.values()]).tolist()))
        losses.append(metrics["loss"])
        n = len(losses)
        if n % args.log_every == 0:
            print(f"  step {start + n:>5}  loss "
                  f"{np.mean(losses[-args.log_every:]):.4f}  "
                  f"gnorm {metrics['grad_norm']:.3f}")
        return st, metrics

    loop = FaultTolerantLoop(logging_step, pipeline, ckpt,
                             ckpt_every=args.ckpt_every,
                             straggler=StragglerMonitor(), device=device)
    state, report = loop.run(state, start, args.steps)
    print(f"[train] done: {report.steps_run} steps, "
          f"{report.bad_steps} rejected, {report.stragglers} stragglers, "
          f"final loss {report.losses[-1]:.4f} "
          f"(first {report.losses[0]:.4f})")
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
