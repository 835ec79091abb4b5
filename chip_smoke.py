#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its lines; any failure exits nonzero:
  1. device: the card's name and power limit; TF32 off.
  2. build: every CUDA source of the port, one nvcc each.
  3. kernels: each kernel against its plain PyTorch version on the card
     at every tested variant and, in f32 and bf16, at the serve path's
     shape, where it is then timed.
  4. serve: full-width smollm-360m (seeded random weights) serves 8
     requests of 900-1024 prompt tokens through ServeEngine; the kernel's
     launch count over that run must be one per layer per prefill wave,
     and the first wave's prefill logits must match the same model with
     the plain attention.
Then one JSON line of kernel numbers, and as the last line
{"ok": true, "device": {...}}. Without a card it exits 1 and prints no
result. Imports nothing of JAX.
"""
from __future__ import annotations

import collections
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FLASH_SRC = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_TPU = "src/repro/kernels/flash_attention/kernel.py:26"
H100_BF16_FLOPS = 989e12     # dense tensor-core peak, SXM data sheet
H100_BYTES_PER_S = 3.35e12   # HBM3 peak

# Kernel variants (name, kwargs, (B, Sq, Skv, H, KV, Dk, Dv)).
VARIANTS = [
    ("causal", dict(causal=True), (2, 130, 130, 4, 2, 32, 32)),
    ("full", dict(causal=False), (2, 130, 130, 4, 2, 32, 32)),
    ("window37", dict(causal=True, window=37), (2, 130, 130, 4, 2, 32, 32)),
    ("softcap30", dict(causal=True, softcap=30.0),
     (2, 130, 130, 4, 2, 32, 32)),
    ("window64_softcap50", dict(causal=True, window=64, softcap=50.0),
     (2, 130, 130, 4, 2, 32, 32)),
    ("mla_dk80_dv64", dict(causal=True, scale=0.125),
     (2, 96, 96, 8, 1, 80, 64)),
    ("ragged77", dict(causal=True), (1, 77, 77, 4, 2, 16, 16)),
    ("ragged_cross50x77", dict(causal=False), (1, 50, 77, 4, 2, 16, 16)),
    ("d256", dict(causal=True), (1, 40, 40, 2, 1, 256, 256)),
]
TOL = {torch.float32: dict(rtol=3e-5, atol=1.2e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=8e-2)}
SMOLLM_SHAPE = (4, 1024, 1024, 15, 5, 64, 64)
# At the serve path's shape (group of 3, 1024 keys) the kernel is held
# to TOL[float32] in f32, and in bf16 to a limit near its reading: both
# versions sum in f32 and round once to bf16, in another order, so an
# element may differ by one bf16 step (2^-8 relative, under rtol). atol
# is ~2.5x the H100 reading of 1.95e-3; one dropped 64-key tile moves
# outputs (|o| ~ 0.05) by ~1e-2 and fails.
SMOLLM_BF16_TOL = dict(rtol=1e-2, atol=5e-3)
# Prefill logits, kernel vs plain attention, bf16 through 32 layers of
# random weights: the one-step roundings of each layer's attention
# output are carried on and grow. The H100 reading is 2.78 of max
# |logit| 296 (0.94%); the limit, 2e-2 of max |logit|, is about twice it.
LOGIT_REL_TOL = 2e-2


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, reps=25, warmup=3):
    """Median of ``reps`` CUDA-event timings of ``fn``, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_breakdown(fn):
    """One call of ``fn`` under torch.profiler: host wall time, summed
    kernel time, the device's busy share (a lower bound: the profiler
    slows the host), the kernel count and the kernels taking most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_name, n = collections.Counter(), 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.self_device_time_total
            n += 1
    busy_us = sum(by_name.values())
    return {"wall_ms": wall_us / 1e3, "device_ms": busy_us / 1e3,
            "busy_share": busy_us / wall_us, "device_ops": n,
            "top_ms": [[name[:48], us / 1e3]
                       for name, us in by_name.most_common(4)]}


def attention_bound_ms(q, k, v, causal, window=None):
    """Least time on an H100 for this call: FLOPs of the (q, k) pairs
    the masks keep (QKᵀ and PV) at the bf16 tensor-core peak, against
    each input read once and the output written once at the HBM rate."""
    B, Sq, H, Dk = q.shape
    Skv, Dv = k.shape[1], v.shape[-1]
    qpos = np.arange(Sq)
    hi = np.minimum(qpos + 1, Skv) if causal else np.full(Sq, Skv)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(Sq, int)
    pairs = int(np.maximum(hi - lo, 0).sum())
    flops = 2.0 * B * H * pairs * (Dk + Dv)
    elt = q.element_size()
    nbytes = elt * (q.numel() + k.numel() + v.numel() + B * Sq * H * Dv)
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def rand_qkv(shape, dtype, seed):
    B, Sq, Skv, H, KV, dk, dv = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(*s, generator=g, device="cuda").to(dtype)
            for s in ((B, Sq, H, dk), (B, Skv, KV, dk), (B, Skv, KV, dv))]


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    log("device", f"nvidia-smi: {card}")
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build()
    log("build", f"{len(libs)} libraries in {time.perf_counter() - t0:.2f}s")
    for name, path in libs.items():
        ptxas = path.with_suffix(".log").read_text()
        regs = [int(w.split()[0]) for w in ptxas.split("Used ")[1:]]
        spills = [ln.strip() for ln in ptxas.splitlines()
                  if "spill" in ln and not ln.strip().startswith(
                      "0 bytes stack frame, 0 bytes spill stores, "
                      "0 bytes spill loads")]
        log("build", f"{name}: {path.relative_to(ROOT)}; registers per "
            f"instance {regs}; spills {spills or 'none'}")


def phase_kernels():
    from repro_torch.kernels.flash_attention.blockwise import \
        blockwise_attention
    from repro_torch.kernels.flash_attention.kernel import flash_attention

    for dtype in (torch.float32, torch.bfloat16):
        for i, (name, kw, shape) in enumerate(VARIANTS):
            q, k, v = rand_qkv(shape, dtype, seed=i)
            got = flash_attention(q, k, v, **kw)
            want = blockwise_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            torch.testing.assert_close(got.float(), want.float(),
                                       **TOL[dtype])
            log("kernels", f"flash_attention {name} {str(dtype)[6:]} "
                f"shape {shape}: max_abs_err {err:.3e} ok")

    errs = {}
    for dtype, tol in ((torch.float32, TOL[torch.float32]),
                       (torch.bfloat16, SMOLLM_BF16_TOL)):
        q, k, v = rand_qkv(SMOLLM_SHAPE, dtype, seed=100)
        got = flash_attention(q, k, v, causal=True)
        want = blockwise_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        errs[dtype] = (got.float() - want.float()).abs().max().item()
        log("kernels", f"flash_attention smollm {str(dtype)[6:]} shape "
            f"{SMOLLM_SHAPE}: max_abs_err {errs[dtype]:.3e} (limit {tol})")
        torch.testing.assert_close(got.float(), want.float(), **tol)
    err = errs[torch.bfloat16]
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kernel_ms = time_ms(lambda: flash_attention(q, k, v, causal=True))
    plain_ms = time_ms(lambda: blockwise_attention(q, k, v, causal=True))
    library_ms = time_ms(lambda: sdpa(qh, kh, vh, is_causal=True,
                                      enable_gqa=True))
    bound_ms, bound_by, flops, nbytes = attention_bound_ms(q, k, v, True)
    row = {"name": "flash_attention", "shape": list(SMOLLM_SHAPE),
           "dtype": "bfloat16", "causal": True, "max_abs_err": err,
           "max_abs_err_f32": errs[torch.float32],
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "flops": flops, "bytes": nbytes,
           "tflops": flops / kernel_ms / 1e9}
    log("kernels", "smollm prefill shape " + json.dumps(row))
    return row


def phase_serve():
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import blockwise, ops
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.models import forward, init_caches, init_model
    from repro_torch.serve import ServeEngine

    cfg = get_config("smollm-360m")
    model = init_model(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    engine = ServeEngine(cfg, model, batch_size=4, capacity=2048,
                         device="cuda")
    rng = np.random.default_rng(0)
    lengths = rng.integers(900, 1025, 8)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    new_tokens = 16
    n_waves = math.ceil(len(prompts) / engine.B)
    log("serve", f"{cfg.name}: {n_params} parameters ({cfg.dtype}), "
        f"{len(prompts)} requests, prompt lengths {lengths.tolist()}, "
        f"{n_waves} waves of {engine.B}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    peak = torch.cuda.max_memory_allocated()

    assert launches == cfg.n_layers * n_waves, (
        f"flash_attention launched {launches} times, expected "
        f"{cfg.n_layers} layers x {n_waves} prefill waves")
    assert len(outs) == len(prompts)
    assert all(len(o) == new_tokens for o in outs)
    assert all(0 <= t < cfg.vocab_size for o in outs for t in o)

    # First wave's prefill logits: kernel against plain attention, same
    # model and inputs.
    toks = torch.from_numpy(engine.pad_wave(prompts[:engine.B])).cuda()
    with torch.inference_mode():
        got, _ = forward(model, {"tokens": toks}, mode="prefill",
                         caches=init_caches(cfg, engine.B, 2048))
        kernel_attention = ops.attention
        ops.attention = lambda q, k, v, **kw: blockwise.blockwise_attention(
            q, k, v, **kw)
        try:
            want, _ = forward(model, {"tokens": toks}, mode="prefill",
                              caches=init_caches(cfg, engine.B, 2048))
        finally:
            ops.attention = kernel_attention
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all(), "non-finite prefill logits"
    assert got.shape == (engine.B, toks.shape[1], cfg.padded_vocab)
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    agree = (got[:, -1].argmax(-1) == want[:, -1].argmax(-1)).float().mean()
    log("serve", f"prefill logits kernel vs plain: max_abs_err {err:.4f} "
        f"of max |logit| {scale:.2f} (limit {LOGIT_REL_TOL} x), "
        f"last-position argmax agreement {agree.item():.2f}")
    assert err <= LOGIT_REL_TOL * scale

    # Where a warm prefill of the first wave and one decode step after it
    # spend their time.
    with torch.inference_mode():
        caches = init_caches(cfg, engine.B, 2048)
        prefill = device_breakdown(lambda: forward(
            model, {"tokens": toks}, mode="prefill", caches=caches))
        step = torch.zeros(engine.B, 1, dtype=torch.long, device="cuda")
        decode = device_breakdown(lambda: forward(
            model, {"tokens": step}, mode="decode", caches=caches,
            pos=toks.shape[1]))
    log("serve", "profile prefill " + json.dumps(prefill))
    log("serve", "profile decode step " + json.dumps(decode))

    pre = engine.timings["prefill_s"]
    dec = engine.timings["decode_s"]
    gen_tokens = sum(len(o) for o in outs)
    row = {"arch": cfg.name, "requests": len(prompts),
           "prompt_tokens": int(lengths.sum()), "new_tokens": new_tokens,
           "waves": n_waves, "flash_launches": launches,
           "prefill_ms": [1e3 * s for s in pre],
           "decode_ms_per_token": 1e3 * statistics.median(dec),
           "wall_s": wall, "tokens_per_s": gen_tokens / wall,
           "prompt_tokens_per_s": int(lengths.sum()) / sum(pre),
           "max_memory_allocated_bytes": peak,
           "first_tokens": outs[0][:8]}
    log("serve", json.dumps(row))
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    card = phase_device()
    phase_build()
    k = phase_kernels()
    launches = phase_serve()
    kernels = [{
        "name": "flash_attention", "route": "cuda", "source": FLASH_SRC,
        "replaces": FLASH_TPU, "launches": launches,
        "max_abs_err": k["max_abs_err"], "ms": k["kernel_ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"]}]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
