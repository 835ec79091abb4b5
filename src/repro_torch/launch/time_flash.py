"""Times a bf16 kernel at the serve paths' prefill shapes, each as the
median of 7 CUDA-event timings of 20 back-to-back calls.

``--kernel flash`` (the default) times flash attention beside PyTorch's
``scaled_dot_product_attention`` (at smollm-360m's, zamba2-2.7b's,
deepseek-v2's MLA and hubert-xlarge's shapes); with ``--check`` it also reads each
shape's error against the plain version: the largest, the largest beyond
rtol 1e-2, and the same two for the plain version with one 64-key tile
dropped from the last 64 rows (what a kernel that skipped a tile would
read). ``--kernel ssd`` and ``--kernel wkv6`` time the Mamba-2 SSD scan
at zamba2-2.7b's prefill shape and WKV-6 at rwkv6-3b's (no PyTorch call
computes either); with ``--check`` they read y's and the final state's
largest error against the plain chunked version and y's largest error
beyond rtol 1e-2. Prints one JSON line. To compare two builds of a
kernel, run it from both checkouts in one session on the card, in the
order a, b, b, a:

    PYTHONPATH=src python -m repro_torch.launch.time_flash \
        [--kernel {flash,ssd,wkv6}] [--check]
"""
from __future__ import annotations

import argparse
import json
import statistics

import torch

from ..device import resolve_device
from ..kernels.flash_attention.blockwise import blockwise_attention
from ..kernels.flash_attention.kernel import flash_attention
from ..kernels.rwkv6.chunked import wkv6_chunked
from ..kernels.rwkv6.kernel import wkv6
from ..kernels.ssm_scan.chunked import ssm_scan_chunked
from ..kernels.ssm_scan.kernel import ssm_scan

# name: (B, Sq, Skv, H, KV, Dk, Dv), the serve path's masks, seed.
SHAPES = {"smollm-360m": ((4, 1024, 1024, 15, 5, 64, 64),
                          dict(causal=True), 100),
          "zamba2-2.7b": ((4, 1024, 1024, 32, 32, 160, 160),
                          dict(causal=True, window=4096), 101),
          # MLA's absorbed latent head: kv_lora 512 + rope 64 keys over
          # 512 values, one KV head, scale 1/sqrt(qk_nope + qk_rope)
          "deepseek-v2-236b": ((4, 1024, 1024, 128, 1, 576, 512),
                               dict(causal=True, scale=192 ** -0.5), 102),
          # the audio encoder over 30 s clips: not causal
          "hubert-xlarge": ((4, 1500, 1500, 16, 16, 80, 80),
                            dict(causal=False), 103)}


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


def ssd_inputs(dev, seed=100, shape=(4, 1024, 80, 64, 1, 64)):
    """zamba2-2.7b's prefill SSD call (B, S, H, P, G, N): x, B, C in bf16,
    dt = softplus of a normal draw, a < 0, D, and the zero state that
    prefill starts from."""
    B, S, H, P, G, N = shape
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s):
        return torch.randn(*s, generator=g, device=dev)
    x = randn(B, S, H, P).bfloat16()
    dt = torch.nn.functional.softplus(randn(B, S, H))
    a = -torch.exp(0.5 * randn(H))
    Bm, Cm = randn(B, S, G, N).bfloat16(), randn(B, S, G, N).bfloat16()
    D = 0.1 * randn(H)
    h0 = torch.zeros(B, H, P, N, device=dev)
    return (x, dt, a, Bm, Cm, D), dict(h0=h0)


def wkv6_inputs(dev, seed=100, shape=(4, 1024, 40, 64)):
    """rwkv6-3b's prefill WKV-6 call (B, S, H, K): r, k, v and the decays
    w (drawn as the model's init draws them, exp(-exp(-4 + N(0, 1)))) in
    bf16, the bonus u, and the zero state that prefill starts from."""
    B, S, H, K = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    r, k, v, x = (torch.randn(B, S, H, K, generator=g, device=dev)
                  for _ in range(4))
    w = torch.exp(-torch.exp(x - 4.0))
    u = 0.125 * torch.randn(H, K, generator=g, device=dev)
    s0 = torch.zeros(B, H, K, K, device=dev)
    return (*(t.bfloat16() for t in (r, k, v, w)), u), dict(s0=s0)


# --kernel: (serve shape's name, inputs, kernel, plain version).
RECURRENT = {
    "ssd": ("zamba2-2.7b", ssd_inputs, ssm_scan,
            lambda *a, **kw: ssm_scan_chunked(*a, chunk=256, **kw)),
    "wkv6": ("rwkv6-3b", wkv6_inputs, wkv6,
             lambda *a, **kw: wkv6_chunked(*a, chunk=32, **kw)),
}


def time_recurrent(kernel_name, dev, check):
    name, inputs, kernel, plain = RECURRENT[kernel_name]
    args, kw = inputs(dev)
    row = {"kernel_burst_ms": burst_ms(lambda: kernel(*args, **kw))}
    if check:
        (y, state), (want_y, want_state) = kernel(*args, **kw), plain(
            *args, **kw)
        row["max_abs_y"] = want_y.float().abs().max().item()
        row["err"], row["err_beyond_rtol"] = errors(want_y, y)
        row["state_err"] = (state - want_state).abs().max().item()
    return {name: row}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=("flash", *RECURRENT),
                    default="flash")
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    out = {"card": torch.cuda.get_device_name(dev)}
    if args.kernel != "flash":
        out.update(time_recurrent(args.kernel, dev, args.check))
        print(json.dumps(out), flush=True)
        return
    sdpa = torch.nn.functional.scaled_dot_product_attention
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
                   lambda: sdpa(qh, kh, vh, is_causal=kw["causal"],
                                scale=kw.get("scale"),
                                enable_gqa=H != KV))}
        if args.check:
            want = blockwise_attention(q, k, v, **kw)
            row["max_abs_o"] = want.float().abs().max().item()
            row["err"], row["err_beyond_rtol"] = errors(
                want, flash_attention(q, k, v, **kw))
            row["drop_tile_err"], row["drop_tile_err_beyond_rtol"] = errors(
                want, blockwise_attention(q, k, v,
                                          **{**kw, "window": Sq - 64}))
        out[name] = row
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
