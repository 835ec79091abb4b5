"""Serving entry point: batched generation with the port's ServeEngine.

On the card (the default), for any ported arch (``--arch`` takes
``configs.PORTED``):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-20b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm3-4b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch pixtral-12b
pixtral-12b serves text prompts (the engine feeds tokens only, as the
JAX package's does; a patch prefill goes through ``models.forward`` with
"patches" in the batch). mixtral-8x22b's 141B parameters (~280 GB in
bf16) and deepseek-v2-236b's 236B (~470 GB) need more than one 80 GB
card, which the serve engine does not shard yet; one card serves them
at the reduced size (`--reduced`):
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-236b --reduced
hubert-xlarge is an encoder with no decode path: the engine refuses it
(ValueError), as the JAX package's does; it runs through
``models.forward(model, {"frames": ...}, mode="train")``.
On the CPU, with the kernels' plain versions, at the reduced size:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --reduced --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs import PORTED, get_config
from ..device import resolve_device
from ..models import init_model
from ..serve import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m",
                    help=f"one of {', '.join(PORTED)}")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--capacity", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    model = init_model(cfg, seed=args.seed, device=device)
    engine = ServeEngine(cfg, model, batch_size=args.batch,
                         capacity=args.capacity,
                         temperature=args.temperature, seed=args.seed,
                         device=device)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size,
                            rng.integers(4, 17)).astype(np.int32)
               for _ in range(args.requests)]
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=args.new_tokens)
    dt = time.perf_counter() - t0
    total = sum(len(o) for o in outs)
    print(f"[serve] {cfg.name} on {device}: {len(prompts)} requests, "
          f"{total} tokens in {dt:.2f}s ({total/dt:.1f} tok/s incl. "
          "kernel build and warm-up)")
    for i, o in enumerate(outs[:4]):
        print(f"  req{i}: {o}")
    return outs


if __name__ == "__main__":
    main()
