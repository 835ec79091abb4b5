"""Times the bf16 flash-attention kernel at the serve paths' prefill
shapes beside PyTorch's ``scaled_dot_product_attention``, each as the
median of 7 CUDA-event timings of 20 back-to-back calls. With
``--check`` it also reads each shape's error against the plain version:
the largest, the largest beyond rtol 1e-2, and the same two for the
plain version with one 64-key tile dropped from the last 64 rows (what a
kernel that skipped a tile would read). Prints one JSON line. To compare
two builds of the kernel, run it from both checkouts in one session on
the card, in the order a, b, b, a:

    PYTHONPATH=src python -m repro_torch.launch.time_flash [--check]
"""
from __future__ import annotations

import argparse
import json
import statistics

import torch

from ..device import resolve_device
from ..kernels.flash_attention.blockwise import blockwise_attention
from ..kernels.flash_attention.kernel import flash_attention

# name: (B, Sq, Skv, H, KV, Dk, Dv), the serve path's masks, seed.
SHAPES = {"smollm-360m": ((4, 1024, 1024, 15, 5, 64, 64),
                          dict(causal=True), 100),
          "zamba2-2.7b": ((4, 1024, 1024, 32, 32, 160, 160),
                          dict(causal=True, window=4096), 101)}


def burst_ms(fn, calls=20, reps=7, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def errors(want, got):
    d = (got.float() - want.float()).abs()
    return d.max().item(), (d - 1e-2 * want.float().abs()).max().item()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {"card": torch.cuda.get_device_name(dev)}
    for name, (shape, kw, seed) in SHAPES.items():
        B, Sq, Skv, H, KV, dk, dv = shape
        g = torch.Generator(device=dev).manual_seed(seed)
        q, k, v = (torch.randn(*s, generator=g, device=dev).bfloat16()
                   for s in ((B, Sq, H, dk), (B, Skv, KV, dk),
                             (B, Skv, KV, dv)))
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        row = {"kernel_burst_ms": burst_ms(
                   lambda: flash_attention(q, k, v, **kw)),
               "sdpa_burst_ms": burst_ms(
                   lambda: sdpa(qh, kh, vh, is_causal=True,
                                enable_gqa=H != KV))}
        if args.check:
            want = blockwise_attention(q, k, v, **kw)
            row["max_abs_o"] = want.float().abs().max().item()
            row["err"], row["err_beyond_rtol"] = errors(
                want, flash_attention(q, k, v, **kw))
            row["drop_tile_err"], row["drop_tile_err_beyond_rtol"] = errors(
                want, blockwise_attention(q, k, v, causal=True,
                                          window=Sq - 64))
        out[name] = row
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
