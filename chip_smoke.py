#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its lines; any failure exits nonzero:
  1. device: the card's name and power limit; TF32 off.
  2. build: every CUDA source of the port, one nvcc each, all started
     together; registers and spills of each kernel, and for every
     library each instantiation's registers, spill bytes and HMMA
     (tensor-core) instructions: a bf16 kernel without HMMA, or a bf16
     kernel spilling at a serve path's shape (flash at head dims 64, 80,
     128, 160, 256, MLA's 288/256 and deepseek-v2's 576/512 through
     <576, 256>, SSD at state dim 64, WKV-6 at head dim 64), fails.
  3. kernels: each kernel (flash attention, WKV-6, the Mamba-2 SSD scan,
     the GEMM) against its plain PyTorch version on the card at every
     tested variant (the calibration pass's sample shapes among them)
     and, in f32 and bf16, at its main path's shape, where it is then
     timed (flash also checked and timed at zamba2-2.7b's
     shared-attention shape in bf16, at minicpm3-4b's MLA latent head
     in bf16 and f32, at gemma2-2b's long-wave local layer in bf16, at
     deepseek-v2's MLA latent head (Dk 576, Dv 512: two value slices) in
     bf16 and f32 and at hubert-xlarge's non-causal encoder in bf16,
     beside SDPA (its kernels named), where limits set from the H100's
     readings must also reject planted faults (at deepseek's, value
     slice 1 reading slice 0's columns too); the GEMM at the calibration's
     largest size and at zamba2-2.7b's in_proj shape); every kernel, and
     the PyTorch call for the same function where there is one, also as
     runs of back-to-back calls. Flash's query offset: 256 query rows at
     offsets 320 and 700 of minicpm3-4b's MLA shape and of smollm-360m's,
     in f32 and bf16, against the plain version at the same offset and
     bit for bit those rows of the whole call; offset 0 bit for bit the
     call without it.
  4. calibrate + plan: with every launch count at 0, the full calibration
     pass (profile_kernels() on the card) must launch each kernel once
     per sample and warm-up or timed call, and no other; the profile
     survives the store; then each of the seven served archs is planned
     on meshes (1, 1) and (2, 2) with the calibrated profile and with
     the data sheet's constants.
  5. serve: full-width smollm-360m, rwkv6-3b and zamba2-2.7b (seeded
     random weights), each serving 8 requests of 900-1024 prompt tokens
     through ServeEngine. Every launch count is set to 0 just before a
     path and read just after: each kernel of the path must have launched
     once per layer (flash in zamba2: once per shared-attention group)
     per prefill wave, the other kernels never. The first wave's prefill
     logits must match the same model with the kernel's plain version;
     for rwkv6-3b and zamba2-2.7b also the recurrent states that prefill
     leaves and the logits of the decode step after it. Then the model
     zoo at published widths, the flash kernel once per layer and wave:
     internlm2-20b (48 layers, 4 requests), gemma2-2b (26 layers, 8
     requests and a wave of 2 past its 4096 window, whose last 256
     positions' logits are held too), minicpm3-4b (62 layers, MLA's
     latent head, 8 requests) and mixtral-8x22b (4 of 56 layers: 141B
     parameters do not fit one card; 4 requests, T 4096 > 256, so its
     MoE drops routes): each layer's attention, kernel against plain on
     its captured inputs, element by element, with planted faults (a
     lost KV tile, a window one tile too wide) that the same limit must
     reject; the prefill logits against plain within LOGIT_REL_TOL or
     LOGIT_SPREAD_FACTOR times the plain version's own spread (mixtral's
     reported, with the routes that differ end to end and the drops);
     deepseek-v2-236b (4 of 60 layers: the dense first layer and 3 MoE
     layers of 160 experts top 6 with 2 shared experts; MLA at Dk 576 /
     Dv 512; 4 requests, its routes reported as mixtral's); pixtral-12b
     (40 layers, 4 text requests, then a patch prefill through forward:
     4 requests of 1024 patches and 512-1024 text tokens, its loss mask
     checked, 8 decode steps past the patches). Then hubert-xlarge's
     encoder (48 layers, forward mode "train": 4 clips of 1500 frames,
     unmasked and span-masked), held as the zoo is; its prefill and the
     serve engine refuse it.
  6. optimize: the paper's front door (repro_torch.core.api.optimize) on
     ViT-B/16 over a 4x4 type-A HBM MCM, the four Table-3 schemes on
     the latency objective and pipelining at batch 8. With the default
     MIQPConfig the lattice scores every chunk with the float64 torch
     evaluator on the card: its call counter must equal the lattice's
     scoring calls, all on cuda. The same solve on the numpy backend
     must agree (the tie contract); then the card's solve under
     torch.profiler (kernels, copies and blocked host time per scoring
     call, the device's busy share) and the AUTO_POPULATION_THRESHOLD
     crossover, torch on the card vs numpy at P = 1..4096. No kernel
     of the port lies on this path: every launch count stays 0.
  7. sweeps: the paper's batched solvers (repro_torch.core.sweep) at the
     paper's sizes: Fig. 9/10's GA leg (four workloads on 4x4, 8x8 and
     16x16 type-A HBM, both objectives) through solve_grid on the card,
     every fitness call counted on cuda and every record held to the
     JAX suite's GA invariants (on real layer dims: shares on the unit
     lattice of the repaired uniform partition); fig_hetero's island batch (2 groups of
     3), one island of each group solved alone and equal bit for bit,
     beside the numpy engine's time, and one island solve profiled (its
     host syncs, counted by torch's sync debug mode, one per chunk);
     the device GA's quality within 1% of the python engine (median of
     5 seeds); MIQP through solve_grid equal to solo solves; Fig. 11's
     pipelining (64 points, 16 groups) through pipeline_sweep: the SGS
     kernel launches once per group, its schedules bit-identical to its
     plain version, the host frontier and list_schedule, and it is timed
     at the largest group beside its bound. The TPU kernels' counts stay
     0.
  8. flow congestion (repro_torch.core with congestion="flow"): Fig. 3's
     grid through netsim_sweep in one launch of the waterfilling kernel,
     held to the numpy netsim (latency and done times bit-identical is
     reported) with the paper's three ratios; Fig. 8's LS column of the
     four workloads on 4x4 types A-D under both congestion models
     through eval_sweep, flow held to numpy at rtol 1e-9; Fig. 11's flow
     segments of MIQP schedules (AlexNet, ViT, HydraNet) through
     pipeline_sweep at batches 2-16, held to numpy and to the plain SGS
     bit for bit; a GA under flow on ViT-B/16 at 16x16 (P 64): every
     fitness call on cuda, one launch a generation, one sync a chunk,
     profiled; the kernel at that shape timed beside its bound, its
     plain version (whole launch) and, on 32 sampled simulations, the
     plain version and numpy; the JAX suite's toy solve_grid under flow,
     cached. The TPU kernels' counts stay 0.
  9. multi-tenant packages, the server and sharding: fig_hetero's
     multi-tenant leg (AlexNet + ViT-B/16 on the two-class 4x4 grid),
     uniform held to numpy (slowdowns bit for bit, scores at rtol 1e-9)
     and GA (P 64, G 60) beating the even split with every fitness call
     on cuda; the paper's four workloads as four tenants on 16x16 type
     A, the contention of all 64 band assignments in ONE waterfilling
     launch, bit for bit numpy's per-assignment loop, the assignment
     numpy's, the kernel at that shape beside its bound and plain
     version; the optimisation server (repro_torch.serve.OptServer) on
     the CLI demo's 64 requests plus fig_hetero's GA points and the
     four-tenant solve: served == solo bit for bit, its stats, one
     malformed request failing alone, a kill and a restart from a store
     in build/ serving everything again with no cache miss and no
     kernel launch; devices="sharded" with the card listed once and
     three times on eval (both congestion models), GA islands,
     netsim_sweep, pipeline_sweep and the MIQP lattice, bit for bit the
     single-device records. The TPU kernels' counts stay 0.
 10. co-search (repro_torch.core.cosearch, DESIGN.md §16): one
     cosearch_sweep on DESIGN.md §16's fig13 grid (AlexNet, ViT-B/16,
     HydraNet at batch 1 on a 4x4 type-A HBM MCM, population 48,
     patience 8, EDP, regime congestion): per workload its wall time and
     seeding time on the host clock, generations, SGS launches (one a
     generation), front size; each evolution re-run from its seeds under
     torch.profiler (kernels a generation, host waits, busy share) and
     equal to the sweep's record, one host sync a chunk; every best
     genome re-scored by the numpy evaluator and the serial SGS at rtol
     1e-9, every front non-dominated, every best EDP at most the better
     uniform baseline row's; two AlexNet points of one shape solved
     together equal to their solo records; one flow-congestion search on
     AlexNet (one SGS and one waterfilling launch a generation),
     re-scored by the numpy flow evaluator. The TPU kernels' counts
     stay 0.
 11. train: smollm-360m at full width and depth (32 layers, d_model 960,
     f32 masters, bf16 compute) through repro_torch.launch.train.main:
     batch 8, seq 2048, 10 steps, a checkpoint every 5 into a temporary
     directory under build/, then a second main with --restore auto for 4
     steps. Each run's launches are counted: flash twice per layer and
     step (the forward and the per-block remat's recompute; the kernels'
     backward is autograd of the plain version and launches nothing).
     Every loss finite, the loss falling over the 10 steps, the restart
     resuming at step 10 with restores 0 and steps_run 4, as JAX's
     driver reports them. The first step through the kernels against the
     same step through the plain versions (loss, global grad norm, each
     parameter's grad norm; the limits TRAIN_*_RTOL), and a planted fault
     (the flash backward returning a zero dk) rejected by them; one warm
     step under torch.profiler (busy share). Then rwkv6-3b (2 layers) and
     zamba2-2.7b (one group of 6 Mamba-2 layers and its shared attention
     block) at published widths, batch 4, seq 1024, 3 steps each through
     the same train step and FaultTolerantLoop: WKV-6 twice a layer and
     step, SSD twice a Mamba-2 layer and flash twice a group.
 12. mesh: the sharded layer (repro_torch.launch.dryrun, the partition
     rules as DTensor placements). Four dry runs on a fake world of
     256 or 512 ranks in this process, tensors with shapes and no
     memory, depth cut: smollm-360m train_4k on (16, 16) (2 of 32
     layers), deepseek-v2-236b train_4k on (2, 16, 16) (its dense layer
     and one MoE layer, accumulation 1 where the policy has 8) and
     minicpm3-4b prefill_32k with its perf_knobs (2 of 62 layers, attention
     chunks of 4096: the plain version computes every block, so the
     FLOPs do not change) and hubert-xlarge train_4k at accumulation 2
     (2 of 48 layers; its frames gathered once a step for the global
     batch's microbatches); per-device memory, FLOPs and collective bytes
     and the trace's seconds; argument bytes equal to the local shards'
     bytes the specs give. Then the card as a (1, 1) NCCL mesh:
     execute_plan for smollm-360m at full width (2 layers, prefill, seq
     512, batch 8) run for real, flash launched once a layer, the
     projections' mm/addmm/bmm FLOPs counted on the card equal to the
     fake (1, 1) dry run's of the same cell, allocated argument bytes
     within 1% of the prediction, peak memory beside the prediction;
     launch.train --mesh debug at full width (4 of 32 layers, batch 8,
     seq 512, 3 steps), each loss within MESH_LOSS_RTOL of the meshless
     trainer's and the launch counts equal; compressed_all_reduce_mean
     on the 1-rank group bit for bit dequantize(quantize(g + err)), and a
     planted fault (err dropped) rejected. minicpm3-4b's dry run reads
     the attn_qchunk rule: its attention FLOPs per device are its batch
     share's and its rows' of each query chunk (logged beside the cell's
     record from before the rule was read); and reduced minicpm3-4b's prefill under that
     rule on the (1, 1) mesh, flash launched once a query chunk at its
     offset, its logits against the meshless prefill's (f32 and bf16).
 13. entry points: launch.plan_mesh (the calibration pass on the card,
     then every arch planned on a 16x16 grid of cards) and
     launch.optserve_client (evals under regime and flow, a GA solve, a
     pipeline through OptServer on the card, then a warm restart served
     from its store through submit_async: every request a hit, results
     equal to the cold pass's), each with its launches counted.
Then one JSON line of kernel numbers, and as the last line
{"ok": true, "device": {...}}. Without a card it exits 1 and prints no
result. Imports nothing of JAX.
"""
from __future__ import annotations

import collections
import functools
import json
import math
import re
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
WKV6_SRC = "src/repro_torch/kernels/csrc/wkv6.cu"
WKV6_TPU = "src/repro/kernels/rwkv6/kernel.py:21"
SSD_SRC = "src/repro_torch/kernels/csrc/ssm_scan.cu"
SSD_TPU = "src/repro/kernels/ssm_scan/kernel.py:24"
GEMM_SRC = "src/repro_torch/kernels/csrc/gemm.cu"
GEMM_TPU = "src/repro/kernels/gemm/kernel.py:18"
SGS_SRC = "src/repro_torch/kernels/csrc/sgs_batch.cu"
NETSIM_SRC = "src/repro_torch/kernels/csrc/netsim_waterfill.cu"
NETSIM_REPLACES = ("src/repro/core/netsim_jax.py:79 waterfill_times (with "
                   ":43 waterfill_rates) under vmap (lax.while_loop; no "
                   "pallas_call)")
SGS_REPLACES = ("src/repro/core/pipelining_jax.py:62 sgs_instance "
                "(lax.fori_loop; no Pallas kernel)")
TPU_KERNELS = ("flash_attention", "wkv6", "ssm_scan", "gemm")
H100_BF16_FLOPS = 989e12     # dense tensor-core peak, SXM data sheet
H100_F32_FLOPS = 67e12       # f32 on the CUDA cores, SXM data sheet
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
    # zamba2's shared attention: head dim 160, a window shorter than S
    ("d160_window100", dict(causal=True, window=100),
     (1, 300, 300, 4, 4, 160, 160)),
    # the calibration pass's samples: causal, H = KV = 4, head dim 64
    ("calib_s256_d64", dict(causal=True), (1, 256, 256, 4, 4, 64, 64)),
    ("calib_b2_s512_d64", dict(causal=True), (2, 512, 512, 4, 4, 64, 64)),
    # minicpm3-4b's MLA latent head: KV 1, Dk 288, Dv 256, 1/sqrt(96)
    ("mla_dk288_dv256", dict(causal=True, scale=96 ** -0.5),
     (2, 130, 130, 40, 1, 288, 256)),
    # deepseek-v2's: Dk 576, Dv 512 (two value slices), 1/sqrt(192)
    ("mla_dk576_dv512", dict(causal=True, scale=192 ** -0.5),
     (2, 130, 130, 8, 1, 576, 512)),
    # hubert-xlarge's encoder: not causal, head dim 80, ragged S
    ("encoder_d80", dict(causal=False), (2, 150, 150, 4, 4, 80, 80)),
]
TOL = {torch.float32: dict(rtol=3e-5, atol=1.2e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=8e-2)}
SMOLLM_SHAPE = (4, 1024, 1024, 15, 5, 64, 64)
# zamba2-2.7b's shared attention in prefill (window 4096 > S: causal).
ZAMBA_ATTN_SHAPE = (4, 1024, 1024, 32, 32, 160, 160)
ZAMBA_WINDOW = 4096
# minicpm3-4b's MLA prefill (the absorbed latent head, scale
# 1/sqrt(qk_nope + qk_rope)), in bf16 and f32; gemma2-2b's local layers
# in its long wave (2 prompts past the window), bf16. (B, Sq, Skv, H, KV,
# Dk, Dv), kwargs. In f32 the kernel is held to TOL[float32]; in bf16 to
# ZOO_BF16_TOL, set as ZAMBA_BF16_TOL is: rtol one bf16 step, atol ~2.5x
# the H100 reading beyond rtol (MLA 2.52e-3, gemma2 2.28e-3: past head
# dim 128 the kernel rounds P to bf16 for the tensor cores, which shows
# where weighted values cancel; deepseek-v2's 3.42e-3, hubert-xlarge's,
# with P split, 3.9e-7).
# A typical |o| is ~0.1 at the MLA shape (~50 keys in view) and ~0.03 at
# gemma2's (~1500), so TOL[bfloat16]'s atol of 8e-2 would hide a lost
# tile. Each check also plants the faults of planted_faults and must
# reject them: on the H100 a dropped tile reads 0.89 (MLA) and 4.1e-2
# (gemma2) beyond rtol, gemma2's window one tile wider 2.9e-2.
MLA_SHAPE = (4, 1024, 1024, 40, 1, 288, 256)
MLA_KW = dict(causal=True, scale=96 ** -0.5)
GEMMA2_SHAPE = (2, 4608, 4608, 8, 4, 256, 256)
GEMMA2_KW = dict(causal=True, window=4096, softcap=50.0)
# deepseek-v2-236b's MLA prefill (kv_lora 512 + rope 64 keys over 512
# values, one KV head, scale 1/sqrt(qk_nope + qk_rope) = 1/sqrt(192): the
# kernel's two value slices) and hubert-xlarge's encoder over 30 s clips
# (1500 frames, a ragged last KV tile, not causal), both held as MLA_SHAPE
# is; at deepseek's shape a planted fault that only the split can make,
# slice 1 reading slice 0's value columns, must be rejected too (the
# H100 reads it at 3.77 beyond rtol, a dropped tile at 2.0).
DEEPSEEK_MLA_SHAPE = (4, 1024, 1024, 128, 1, 576, 512)
DEEPSEEK_MLA_KW = dict(causal=True, scale=192 ** -0.5)
HUBERT_SHAPE = (4, 1500, 1500, 16, 16, 80, 80)
HUBERT_KW = dict(causal=False)
ZOO_BF16_TOL = dict(rtol=1e-2, atol=6e-3)
# The query offset: a slice of OFFSET_ROWS query rows at each of OFFSETS
# (a tile boundary and a row inside a tile) attended against all 1024
# keys, as one rank's rows of a query chunk are on a mesh where
# attn_qchunk splits them (minicpm3-4b prefill_32k: a chunk of 4096 over
# model 16 is 256 rows); at MLA_SHAPE and SMOLLM_SHAPE in f32 and bf16,
# held to the same limits as the full calls there.
OFFSET_ROWS = 256
OFFSETS = (320, 700)
# Planted faults (planted_faults): the last FAULT_ROWS query rows
# recomputed with a tile of FAULT_TILE keys dropped, or the window one
# tile too wide. FAULT_TILE is the bf16 kernel's KV tile at head dims over
# 160 (64 below), so a fault is never larger than a lost tile.
FAULT_ROWS = 64
FAULT_TILE = 32
# At zamba2's shape the bf16 kernel runs its (b, h) pairs in 4 groups
# whose K and V fit in L2 (no other shape here takes more than one). It is
# held to a limit set as SMOLLM_BF16_TOL's: rtol one bf16 step; atol ~2.5x
# the H100 reading of 2.83e-3 beyond rtol (max |o| 3.97, max_abs_err
# 1.56e-2, one bf16 step there); the plain version with one 64-key tile
# dropped from the last 64 rows reads 0.16 beyond rtol and fails.
ZAMBA_BF16_TOL = dict(rtol=1e-2, atol=7e-3)
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

# WKV-6 variants (name, (B, S, H, K), chunk of the plain version, s0 or
# not, share of decays set to 0): the JAX suite's shapes
# (tests/test_kernels.py), then one step, a ragged length, a nonzero
# initial state, the model's K=64, vanishing decays (the plain version
# clamps w at 1e-38, a subnormal), and the calibration pass's samples.
WKV_VARIANTS = [
    ("s32_c16", (2, 32, 3, 16), 16, False, 0.0),
    ("s70_c16", (2, 70, 3, 16), 16, False, 0.0),
    ("s128_c32", (2, 128, 3, 16), 32, False, 0.0),
    ("s1_state", (2, 1, 3, 16), 16, True, 0.0),
    ("s77_state", (2, 77, 3, 16), 16, True, 0.0),
    ("k32_s77_state", (2, 77, 3, 32), 16, True, 0.0),
    ("k64_s100_state", (2, 100, 3, 64), 32, True, 0.0),
    ("k64_decay0", (2, 70, 3, 64), 32, True, 0.25),
    ("calib_k32_s128_c32", (1, 128, 2, 32), 32, False, 0.0),
    ("calib_k32_s256_c32", (2, 256, 2, 32), 32, False, 0.0),
]
# The JAX suite's WKV limits (rtol = atol), on y and on the final state.
WKV_TOL = {torch.float32: 2e-3, torch.bfloat16: 6e-2}
RWKV_SHAPE = (4, 1024, 40, 64)     # rwkv6-3b prefill: B, S, H, K
# At the serve shape in bf16 the two versions read the same bf16 inputs
# and sum the same products in another order in f32 (the kernel as a
# recurrence, the plain version in chunks through exp/log of the
# decays), then round y once to bf16: they may differ by one bf16 step,
# at most 2^-7 of |y| (under rtol). atol covers the f32 sums' own
# difference near y = 0 (the f32 reading at this shape is 7.6e-5).
RWKV_BF16_TOL = dict(rtol=1e-2, atol=5e-3)
# rwkv6-3b and zamba2-2.7b first wave, kernel vs plain version through
# every layer of random weights: prefill logits and decode-step logits are
# held to LOGIT_REL_TOL of the largest |logit|, the recurrent states that
# prefill leaves to these shares of the largest |state|. In bf16 each
# limit is raised to twice the plain versions' own spread where that is
# larger: for rwkv6-3b plain chunk 16 against chunk 32 (the logits read
# about 14% of the largest |logit| on the H100, for the kernel and for
# plain 16 vs 32 alike); for zamba2-2.7b plain chunk 128 and the
# sequential oracle against chunk 256. The two chunked SSD versions
# share their cumulative sums of decays and flip few bf16 roundings
# between them (4.8% of max |logit| on the H100), while any form that
# multiplies the decays step by step, the oracle's or the kernel's,
# flips about ten times as many and reads 30-45% (PERF.md, Findings).
STATE_REL_TOL = 2e-2
STATE_REL_TOL_F32 = 1e-3

# SSD variants (name, (B, S, H, P, G, N), chunk of the plain version, h0
# or not, scale of dt): the JAX suite's shapes (tests/test_kernels.py,
# two state groups, N = 8), then one step, a ragged length, the model's
# G = 1 at N = P = 64, and vanishing decays (dt·|a| up to ~100: exp(dt·a)
# is a subnormal or 0).
SSD_VARIANTS = [
    ("jax_s64_c32", (2, 64, 4, 16, 2, 8), 32, False, 1.0),
    ("jax_s100_c32", (2, 100, 4, 16, 2, 8), 32, False, 1.0),
    ("jax_s256_c64", (2, 256, 4, 16, 2, 8), 64, False, 1.0),
    ("s1_state", (2, 1, 4, 16, 2, 8), 32, True, 1.0),
    ("s77_state", (2, 77, 4, 16, 2, 8), 32, True, 1.0),
    ("g1_n64_p64_s100_state", (2, 100, 3, 64, 1, 64), 64, True, 1.0),
    ("n64_decay0", (2, 70, 4, 64, 1, 64), 32, True, 40.0),
    # the calibration pass's SSD samples: N = 16, P = 16, one group
    ("calib_n16_p16_s512_c64", (2, 512, 2, 16, 1, 16), 64, True, 1.0),
    ("calib_n16_p16_s256_c64", (1, 256, 2, 16, 1, 16), 64, False, 1.0),
]
# The JAX suite's SSD limits (rtol = atol), on y and on the final state,
# at every variant and at the serve shape.
SSD_TOL = {torch.float32: 2e-3, torch.bfloat16: 6e-2}
ZAMBA_SSD_SHAPE = (4, 1024, 80, 64, 1, 64)   # zamba2-2.7b: B, S, H, P, G, N

# GEMM shapes (M, K, N): the JAX suite's (tests/test_kernels.py, ragged
# M, N and K among them), then the calibration pass's (smoke and full),
# each with standard-normal operands as those draw them; then zamba2-2.7b's
# in_proj at the serve shape (4 rows of 1024 tokens, d_model 2560, 2 x
# 5120 + 2 x 64 + 80 outputs), with a the RMS-normed hidden state
# (standard normal) and b at the model's fan-in init scale (1/sqrt(K)).
GEMM_SHAPES = [(128, 128, 128), (256, 512, 128), (100, 70, 130),
               (33, 257, 65), (256, 256, 256), (512, 512, 512),
               (768, 768, 768)]
GEMM_CALIB_SHAPE = (768, 768, 768)        # the calibration's largest
IN_PROJ_SHAPE = (4 * 1024, 2560, 10448)
# The JAX suite's GEMM limits (rtol, atol = 8·rtol): f32 sums of K
# products in another order than cuBLAS's (no TF32 on either side);
# bf16 inputs, f32 sums, one rounding to bf16 on each side.
GEMM_TOL = {torch.float32: dict(rtol=2e-5, atol=1.6e-4),
            torch.bfloat16: dict(rtol=3e-2, atol=0.24)}
# The JAX suite's bf16 limit is set for unit-normal operands (|c| ~ √K).
# At the in_proj shape the weights are at 1/√K, so |c| ~ 1, and the
# limit comes from the output's scale instead: both versions sum in f32
# and round once to bf16, so an element may differ by one bf16 step
# (at most 2^-7 of |c|, the rtol); atol is two bf16 steps at the largest
# output. The H100 reading is 0 (bit-equal, PERF.md); one dropped
# 8-deep K tile moves outputs by ~0.3 there and fails.
IN_PROJ_BF16_RTOL = 2 ** -7
# Launches of one full profile_kernels() pass: samples x (1 warm-up + 3
# timed calls); the pipeliner's SGS kernel and the netsim's waterfilling
# kernel are not on it.
CALIB_LAUNCHES = {"gemm": 12, "flash_attention": 8, "wkv6": 8,
                  "ssm_scan": 8, "sgs_batch": 0, "netsim_waterfill": 0}
# The seven archs phase 4 plans.
SERVED = ("smollm-360m", "rwkv6-3b", "zamba2-2.7b", "gemma2-2b",
          "internlm2-20b", "minicpm3-4b", "mixtral-8x22b")


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


def burst_ms(fn, calls=20, reps=5, warmup=3):
    """Median over ``reps`` of one CUDA-event timing around ``calls``
    back-to-back calls of ``fn``, over ``calls``: the device time of a
    call when the host enqueues faster than the card runs (time_ms, one
    call between its events, adds the host's launch overhead to a call
    shorter than it)."""
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
    the masks keep (QKᵀ and PV) at the peak of their type (bf16 on the
    tensor cores, f32 on the CUDA cores), against each input read once
    and the output written once at the HBM rate."""
    B, Sq, H, Dk = q.shape
    Skv, Dv = k.shape[1], v.shape[-1]
    qpos = np.arange(Sq)
    hi = np.minimum(qpos + 1, Skv) if causal else np.full(Sq, Skv)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(Sq, int)
    pairs = int(np.maximum(hi - lo, 0).sum())
    flops = 2.0 * B * H * pairs * (Dk + Dv)
    elt = q.element_size()
    nbytes = elt * (q.numel() + k.numel() + v.numel() + B * Sq * H * Dv)
    peak = H100_F32_FLOPS if q.dtype == torch.float32 else H100_BF16_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def wkv6_bound_ms(r, s0):
    """Least time on an H100 for this call: r/k/v/w read once, y written
    once, s0 read and sT written once, at the HBM rate, against the
    matrix products of the chunked form (chunk 32) at the bf16
    tensor-core peak."""
    B, S, H, K = r.shape
    Lc = min(32, S)
    flops = 4.0 * B * H * S * (Lc * K + K * K)
    nbytes = (5 * r.numel() * r.element_size()
              + 2 * B * H * K * K * 4 + H * K * 4)
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def ssd_bound_ms(x, Bm, h0):
    """Least time on an H100 for this call: x, dt, B, C (and h0 when
    given) read once, y and hT written once, at the HBM rate, against the
    matrix products of the chunked form (chunk 256; C·Bᵀ once per state
    group) at the bf16 tensor-core peak."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Lc = min(256, S)
    nc = math.ceil(S / Lc)
    flops = 2.0 * B * nc * Lc * (G * Lc * N + H * (Lc * P + 2 * N * P))
    elt = x.element_size()
    nbytes = (2 * x.numel() * elt + 4 * B * S * H + 2 * Bm.numel() * elt
              + (1 if h0 is None else 2) * 4 * B * H * P * N + 2 * 4 * H)
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def gemm_bound_ms(m, k, n, dtype):
    """Least time on an H100 for C = A·B: 2·M·K·N operations at the peak
    of their type (f32 on the CUDA cores, bf16 on the tensor cores),
    against A and B read once and C written once at the HBM rate."""
    flops = 2.0 * m * k * n
    peak = H100_F32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS
    nbytes = (m * k + k * n + m * n) * (4 if dtype == torch.float32 else 2)
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def rand_ssd(shape, dtype, seed, state=True, dt_scale=1.0):
    """x, dt, a, B, C, D as the Mamba-2 layer passes them (x, B, C in
    ``dtype``; dt = softplus of a normal draw, times ``dt_scale``, a < 0,
    D in f32), and h0 (f32) or None."""
    B, S, H, P, G, N = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*s):
        return torch.randn(*s, generator=g, device="cuda")
    x = randn(B, S, H, P).to(dtype)
    dt = dt_scale * torch.nn.functional.softplus(randn(B, S, H))
    a = -torch.exp(0.5 * randn(H))
    Bm, Cm = randn(B, S, G, N).to(dtype), randn(B, S, G, N).to(dtype)
    D = 0.1 * randn(H)
    h0 = 0.3 * randn(B, H, P, N) if state else None
    return (x, dt, a, Bm, Cm, D), h0


def rand_wkv(shape, dtype, seed, state=True, zero_share=0.0, model_w=False):
    """r, k, v, w in ``dtype``; u and s0 (or None) in f32. ``model_w``
    draws the decays as rwkv6-3b's init does, exp(-exp(-4 + N(0, 1)))."""
    B, S, H, K = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    r, k, v, x = (torch.randn(B, S, H, K, generator=g, device="cuda")
                  for _ in range(4))
    w = torch.exp(-torch.exp(x - 4.0 if model_w else 0.5 * x))
    if zero_share:
        keep = torch.rand(B, S, H, K, generator=g, device="cuda")
        w = torch.where(keep < zero_share, 0.0, w)
    u = (0.125 if model_w else 0.3) * torch.randn(H, K, generator=g,
                                                  device="cuda")
    s0 = (0.3 * torch.randn(B, H, K, K, generator=g, device="cuda")
          if state else None)
    return [t.to(dtype) for t in (r, k, v, w)], u, s0


def rand_qkv(shape, dtype, seed):
    B, Sq, Skv, H, KV, dk, dv = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(*s, generator=g, device="cuda").to(dtype)
            for s in ((B, Sq, H, dk), (B, Skv, KV, dk), (B, Skv, KV, dv))]


CARD = None     # nvidia-smi's name and power limit (phase_device)


def phase_device():
    global CARD
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    log("device", f"nvidia-smi: {card}")
    CARD = card
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def kernel_labels(mangled, bindir):
    """``flash_bf16_kernel<160>`` for each mangled kernel name, from the
    toolkit's ``cu++filt`` (which prints ``flash_bf16_kernel<(int)160>``
    in its full signature)."""
    out = subprocess.run([str(Path(bindir) / "cu++filt"), *mangled],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.splitlines()
    labels = {}
    for m, d in zip(mangled, out):
        hit = re.search(r"(\w+(?:<[^>]*>)?)\(", d)
        labels[m] = re.sub(r"\(\w+\)", "", hit[1] if hit else d)
    return labels


def ptxas_usage(log_text):
    """Per mangled kernel name of a ``-Xptxas=-v`` log: (registers, spill
    store bytes, spill load bytes)."""
    usage, name, spills = {}, None, (0, 0)
    for line in log_text.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            spills = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            usage[name] = (int(m.group(1)), *spills)
            name, spills = None, (0, 0)
    return usage


def hmma_counts(lib, bindir):
    """HMMA (tensor-core mma) instructions per mangled kernel name in the
    SASS of ``lib``."""
    sass = subprocess.run([str(Path(bindir) / "cuobjdump"), "--dump-sass",
                           str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, name = collections.Counter(), None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            name = m.group(1)
            counts[name] += 0
        elif name and re.search(r"\bHMMA\b", line):
            counts[name] += 1
    return counts


# The bf16 instantiations that the serve paths launch, which must not
# spill: flash at smollm-360m's and zamba2-2.7b's head dims, at
# internlm2-20b's, mixtral-8x22b's and pixtral-12b's 128, gemma2-2b's
# 256, minicpm3-4b's MLA latent head, deepseek-v2's (<576, 256>, over two
# value slices) and hubert-xlarge's 80 (flash_bf16_kernel<DK, DV> takes
# the key and value widths rounded up to 16), SSD at zamba2-2.7b's state
# dim, WKV-6 at rwkv6-3b's head dim.
SERVE_INSTANCES = {"flash_attention": tuple(
    f"flash_bf16_kernel<{dk}, {dv}>" for dk, dv in (
        (64, 64), (160, 160), (128, 128), (256, 256), (288, 256),
        (576, 256), (80, 80))),
                   "ssm_scan": ("ssd_bf16_kernel<64>",),
                   "wkv6": ("wkv6_bf16_kernel<64>",),
                   "gemm": ()}


def phase_build():
    """Every source built; registers and spills of each kernel; for every
    library, each instantiation's registers, spill bytes and HMMA count.
    Fails if a bf16 kernel has no HMMA (its products would not reach the
    tensor cores) or if a serve path's bf16 instantiation spills."""
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
    bindir = Path(_build.find_nvcc()).parent
    for name, serve in SERVE_INSTANCES.items():
        raw = ptxas_usage(libs[name].with_suffix(".log").read_text())
        hmma = hmma_counts(libs[name], bindir)
        labels = kernel_labels(sorted(raw.keys() | hmma.keys()), bindir)
        usage = {labels[k]: u for k, u in raw.items()}
        hmma = {labels[k]: n for k, n in hmma.items()}
        log("build", f"{name}: {sum(hmma.values())} HMMA instructions")
        for kernel, (regs, st, ld) in sorted(usage.items()):
            log("build", f"  {kernel}: {regs} registers, spill stores {st} "
                f"B, spill loads {ld} B, {hmma.get(kernel, 0)} HMMA")
        bf16 = [k for k in usage if "bf16" in k]
        assert bf16 and all(hmma.get(k, 0) > 0 for k in bf16), (
            f"{name}: a bf16 kernel without HMMA: {hmma}")
        for kernel in serve:
            regs, st, ld = usage[kernel]
            assert st == ld == 0, f"{kernel} spills {st}/{ld} B"


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
    def kernel():
        return flash_attention(q, k, v, causal=True)

    def library():
        return sdpa(qh, kh, vh, is_causal=True, enable_gqa=True)
    kernel_ms = time_ms(kernel)
    plain_ms = time_ms(lambda: blockwise_attention(q, k, v, causal=True))
    library_ms = time_ms(library)
    bound_ms, bound_by, flops, nbytes = attention_bound_ms(q, k, v, True)
    row = {"name": "flash_attention", "shape": list(SMOLLM_SHAPE),
           "dtype": "bfloat16", "causal": True, "max_abs_err": err,
           "max_abs_err_f32": errs[torch.float32],
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "kernel_burst_ms": burst_ms(kernel),
           "library_burst_ms": burst_ms(library),
           "library_kernels": device_breakdown(library)["top_ms"],
           "bound_ms": bound_ms,
           "bound_by": bound_by, "flops": flops, "bytes": nbytes,
           "tflops": flops / kernel_ms / 1e9}
    log("kernels", "smollm prefill shape " + json.dumps(row))

    # zamba2-2.7b's shared attention (head dim 160) at its serve shape.
    q, k, v = rand_qkv(ZAMBA_ATTN_SHAPE, torch.bfloat16, seed=101)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kw = dict(causal=True, window=ZAMBA_WINDOW)
    got = flash_attention(q, k, v, **kw).float()
    want = blockwise_attention(q, k, v, **kw).float()
    zerr = (got - want).abs().max().item()
    log("kernels", f"flash_attention zamba2 bfloat16 shape {ZAMBA_ATTN_SHAPE}"
        f": max_abs_err {zerr:.3e} (limit {ZAMBA_BF16_TOL})")
    torch.testing.assert_close(got, want, **ZAMBA_BF16_TOL)
    del got, want
    bound_ms, bound_by, flops, nbytes = attention_bound_ms(
        q, k, v, True, ZAMBA_WINDOW)
    def zkernel():
        return flash_attention(q, k, v, **kw)

    def zlibrary():
        return sdpa(qh, kh, vh, is_causal=True)
    zrow = {"name": "flash_attention", "shape": list(ZAMBA_ATTN_SHAPE),
            "dtype": "bfloat16", "causal": True, "window": ZAMBA_WINDOW,
            "max_abs_err": zerr, "kernel_ms": time_ms(zkernel),
            "plain_ms": time_ms(lambda: blockwise_attention(q, k, v, **kw)),
            "library_ms": time_ms(zlibrary),
            "kernel_burst_ms": burst_ms(zkernel),
            "library_burst_ms": burst_ms(zlibrary),
            "library_kernels": device_breakdown(zlibrary)["top_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
            "bytes": nbytes}
    zrow["tflops"] = flops / zrow["kernel_ms"] / 1e9
    log("kernels", "zamba2 shared-attention prefill shape "
        + json.dumps(zrow))
    del q, k, v, qh, kh, vh
    for label, shape, kw, tols in (
            ("minicpm3 MLA", MLA_SHAPE, MLA_KW,
             ((torch.bfloat16, ZOO_BF16_TOL),
              (torch.float32, TOL[torch.float32]))),
            ("gemma2 local layer, long wave", GEMMA2_SHAPE, GEMMA2_KW,
             ((torch.bfloat16, ZOO_BF16_TOL),)),
            ("deepseek-v2 MLA", DEEPSEEK_MLA_SHAPE, DEEPSEEK_MLA_KW,
             ((torch.bfloat16, ZOO_BF16_TOL),
              (torch.float32, TOL[torch.float32]))),
            ("hubert-xlarge encoder", HUBERT_SHAPE, HUBERT_KW,
             ((torch.bfloat16, ZOO_BF16_TOL),))):
        for dtype, tol in tols:
            log("kernels", f"flash_attention {label} prefill shape "
                + json.dumps(flash_zoo_row(shape, dtype, kw, tol)))
    flash_offsets()
    return row


def flash_offsets():
    """The kernel with ``q_offset``: a slice of query rows at its
    positions against the plain version at the same offset, and bit for
    bit those rows of the whole call (the same rows, attended alone: a
    key tile the mask hides adds exactly nothing); offset 0 bit for bit
    the call without it."""
    from repro_torch.kernels.flash_attention.blockwise import \
        blockwise_attention
    from repro_torch.kernels.flash_attention.kernel import flash_attention

    for label, shape, kw, tols in (
            ("minicpm3 MLA", MLA_SHAPE, MLA_KW,
             ((torch.bfloat16, ZOO_BF16_TOL),
              (torch.float32, TOL[torch.float32]))),
            ("smollm", SMOLLM_SHAPE, dict(causal=True),
             ((torch.bfloat16, SMOLLM_BF16_TOL),
              (torch.float32, TOL[torch.float32])))):
        for dtype, tol in tols:
            q, k, v = rand_qkv(shape, dtype, seed=103)
            whole = flash_attention(q, k, v, **kw)
            same = torch.equal(flash_attention(q, k, v, q_offset=0, **kw),
                               whole)
            out = {"offset_0_bit_for_bit": same}
            for off in OFFSETS:
                qs = q[:, off:off + OFFSET_ROWS]
                got = flash_attention(qs, k, v, q_offset=off, **kw)
                want = blockwise_attention(qs, k, v, q_offset=off, **kw)
                rows = whole[:, off:off + OFFSET_ROWS]
                out[off] = {
                    "max_abs_err": (got.float() - want.float()).abs().max()
                    .item(),
                    "beyond_rtol": excess(got, want, tol["rtol"]),
                    "vs_whole_call_max_abs": (got.float() - rows.float())
                    .abs().max().item(),
                    "kernel_ms": time_ms(lambda: flash_attention(
                        qs, k, v, q_offset=off, **kw))}
                torch.testing.assert_close(got.float(), want.float(), **tol)
            log("kernels", f"flash_attention q_offset {label} "
                f"{str(dtype)[6:]} {OFFSET_ROWS} rows of {shape}: "
                + json.dumps({**out, "limit": tol}))
            assert same, "q_offset=0 differs from the call without it"
            assert all(out[off]["vs_whole_call_max_abs"] == 0
                       for off in OFFSETS), "a slice differs from its rows"
            del q, k, v, whole


def excess(got, want, rtol):
    """The largest |got - want| beyond rtol * |want|: assert_close at
    (rtol, atol) passes exactly when this is at most atol."""
    got, want = got.float(), want.float()
    return ((got - want).abs() - rtol * want.abs()).max().item()


def attention_rows(q, k, v, kw, drop=None, window=None):
    """The last FAULT_ROWS query rows of an attention with Sq == Skv,
    dense in f32 and rounded to q's dtype: under kw's mask, or with a
    planted fault (the keys in range ``drop`` masked out, or ``window``
    in place of kw's; a fault of the value split passes v with slice 0's
    columns in slice 1's place)."""
    B, S, H, Dk = q.shape
    KV, Dv = k.shape[2], v.shape[-1]
    rows = min(FAULT_ROWS, S)
    qr = q[:, -rows:].float().reshape(B, rows, KV, H // KV, Dk)
    s = torch.einsum("bqkgd,bskd->bkgqs", qr, k.float())
    s = s * (kw.get("scale") or Dk ** -0.5)
    if kw.get("softcap"):
        s = kw["softcap"] * torch.tanh(s / kw["softcap"])
    qpos = torch.arange(S - rows, S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    keep = kpos <= qpos if kw.get("causal", True) else kpos >= 0
    window = window or kw.get("window")
    if window:
        keep = keep & (kpos > qpos - window)
    if drop is not None:
        keep = keep & ((kpos < drop.start) | (kpos >= drop.stop))
    # The kernel's finite NEG_INF: a row whose keys a fault all drops
    # (a window shorter than a tile) gets a value, not NaN.
    p = torch.softmax(s.masked_fill(~keep, -2.0e38), dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, rows, H, Dv).to(q.dtype)


# The bf16 kernel's value slice: wider values run in slices of it.
VALUE_SLICE = 256


def planted_faults(q, k, v, kw, want, rtol):
    """How far beyond rtol the last FAULT_ROWS rows of ``want`` (the
    plain version's output) lie from: the same rows computed densely
    ("dense", the control, which a limit must pass), the rows with a tile
    of FAULT_TILE keys in the middle of the last row's view dropped,
    where the window binds the rows with the window one tile too wide,
    and where the kernel splits the values (Dv > VALUE_SLICE) the rows
    with value slice 1 computed from slice 0's columns (faults, which a
    limit must reject)."""
    S, window, Dv = k.shape[1], kw.get("window"), v.shape[-1]
    rows = want[:, -FAULT_ROWS:]
    lo = max(0, S - window) if window else 0
    t0 = (lo + S) // 2 // FAULT_TILE * FAULT_TILE
    out = {"dense": excess(attention_rows(q, k, v, kw), rows, rtol),
           "tile dropped": excess(attention_rows(
               q, k, v, kw, drop=range(t0, t0 + FAULT_TILE)), rows, rtol)}
    if window and S - FAULT_ROWS > window:
        out["window one tile wider"] = excess(attention_rows(
            q, k, v, kw, window=window + FAULT_TILE), rows, rtol)
    if Dv > VALUE_SLICE:
        w = min(VALUE_SLICE, Dv - VALUE_SLICE)
        v_bad = v.clone()
        v_bad[..., VALUE_SLICE:VALUE_SLICE + w] = v[..., :w]
        out["value slice 1 reads slice 0"] = excess(
            attention_rows(q, k, v_bad, kw), rows, rtol)
    return out


def sdpa_backends(call):
    """The backends of scaled_dot_product_attention that take ``call``
    when each is the only one allowed (``sdpa_kernel``); the kernel
    names of a profiled call say which of them the default dispatch
    ran. A refusal is PyTorch's RuntimeError, not a fault of the
    port."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    taken = []
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                call()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        taken.append(backend.name)
    return taken


def hold_planted(faults, atol, what):
    """The control within atol; every planted fault beyond it."""
    assert faults["dense"] <= atol, (
        f"{what}: the dense control reads {faults['dense']:.3e} beyond "
        f"rtol, over atol {atol:.3e}")
    for name, e in faults.items():
        assert name == "dense" or e > atol, (
            f"{what}: planted fault '{name}' reads {e:.3e} beyond rtol, "
            f"within atol {atol:.3e}: the limit would not catch it")


def flash_zoo_row(shape, dtype, kw, tol):
    """The kernel at a zoo model's prefill shape: held to its plain
    version within ``tol``, which must reject the planted faults, and
    timed beside its bound, the plain version and SDPA (which has no
    soft-cap: for gemma2 it takes the window as a boolean mask and skips
    the cap, a yardstick of nearby work; an SDPA error is written down
    instead of a time), with the kernels SDPA ran (its backend) from
    torch.profiler."""
    from repro_torch.kernels.flash_attention.blockwise import \
        blockwise_attention
    from repro_torch.kernels.flash_attention.kernel import flash_attention

    q, k, v = rand_qkv(shape, dtype, seed=102)
    got = flash_attention(q, k, v, **kw)
    want = blockwise_attention(q, k, v, **kw)
    err = (got.float() - want.float()).abs().max().item()
    beyond = excess(got, want, tol["rtol"])
    faults = planted_faults(q, k, v, kw, want, tol["rtol"])
    what = f"flash_attention {shape} {str(dtype)[6:]}"
    log("kernels", f"{what}: max_abs_err {err:.3e}, beyond rtol "
        f"{beyond:.3e} (limit {tol}); planted, beyond rtol: "
        + ", ".join(f"{n} {e:.3e}" for n, e in faults.items()))
    torch.testing.assert_close(got.float(), want.float(), **tol)
    hold_planted(faults, tol["atol"], what)
    del got, want
    S, window, causal = shape[1], kw.get("window"), kw.get("causal", True)
    mask = None
    if window:
        pos = torch.arange(S, device="cuda")
        mask = (pos[None, :] <= pos[:, None]) & (
            pos[None, :] > pos[:, None] - window)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        return sdpa(qh, kh, vh, attn_mask=mask,
                    is_causal=causal and mask is None,
                    scale=kw.get("scale"), enable_gqa=True)
    try:
        library_ms, library_error = time_ms(library), None
        library_burst = burst_ms(library)
        library_kernels = device_breakdown(
            lambda: [library() for _ in range(3)])["top_ms"]
    except RuntimeError as e:
        library_ms = library_burst = library_kernels = None
        library_error = str(e).splitlines()[0][:200]
    backends = sdpa_backends(library)

    def kernel():
        return flash_attention(q, k, v, **kw)
    bound_ms, bound_by, flops, nbytes = attention_bound_ms(
        q, k, v, causal, window)
    row = {"name": "flash_attention", "shape": list(shape),
           "dtype": str(dtype)[6:], **kw,
           "max_abs_err": err, "beyond_rtol": beyond, "limit": tol,
           "planted_beyond_rtol": faults,
           "kernel_ms": time_ms(kernel), "kernel_burst_ms": burst_ms(kernel),
           "plain_ms": time_ms(lambda: blockwise_attention(q, k, v, **kw),
                               reps=5),
           "library_ms": library_ms, "library_burst_ms": library_burst,
           "library_kernels": library_kernels,
           "library_backends_taking_it": backends,
           "library_error": library_error, "bound_ms": bound_ms,
           "bound_by": bound_by, "flops": flops, "bytes": nbytes}
    row["tflops"] = flops / row["kernel_ms"] / 1e9
    return row


def phase_wkv6():
    from repro_torch.kernels.rwkv6.chunked import wkv6_chunked
    from repro_torch.kernels.rwkv6.kernel import wkv6

    def check(name, rkvw, u, s0, chunk, tol):
        y, sT = wkv6(*rkvw, u, s0=s0)
        want_y, want_s = wkv6_chunked(*rkvw, u, s0=s0, chunk=chunk)
        torch.cuda.synchronize()
        err_y = (y.float() - want_y.float()).abs().max().item()
        err_s = (sT - want_s).abs().max().item()
        log("kernels", f"wkv6 {name}: max_abs_err y {err_y:.3e} state "
            f"{err_s:.3e} (limit {tol})")
        assert torch.isfinite(y).all() and torch.isfinite(sT).all()
        torch.testing.assert_close(y.float(), want_y.float(), **tol)
        torch.testing.assert_close(sT, want_s, **tol)
        return err_y, err_s

    for dtype in (torch.float32, torch.bfloat16):
        tol = dict(rtol=WKV_TOL[dtype], atol=WKV_TOL[dtype])
        for i, (name, shape, chunk, state, zeros) in enumerate(WKV_VARIANTS):
            rkvw, u, s0 = rand_wkv(shape, dtype, seed=i, state=state,
                                   zero_share=zeros)
            check(f"{name} {str(dtype)[6:]} shape {shape} chunk {chunk}",
                  rkvw, u, s0, chunk, tol)

    errs = {}
    for dtype, tol in ((torch.float32, dict(rtol=WKV_TOL[torch.float32],
                                            atol=WKV_TOL[torch.float32])),
                       (torch.bfloat16, RWKV_BF16_TOL)):
        rkvw, u, _ = rand_wkv(RWKV_SHAPE, dtype, seed=100, model_w=True)
        s0 = torch.zeros(RWKV_SHAPE[0], RWKV_SHAPE[2], RWKV_SHAPE[3],
                         RWKV_SHAPE[3], device="cuda")
        errs[dtype] = check(f"rwkv6-3b {str(dtype)[6:]} shape {RWKV_SHAPE}",
                            rkvw, u, s0, 32, tol)
    def kernel():
        return wkv6(*rkvw, u, s0=s0)
    kernel_ms = time_ms(kernel)
    plain_ms = time_ms(lambda: wkv6_chunked(*rkvw, u, s0=s0, chunk=32))
    bound_ms, bound_by, flops, nbytes = wkv6_bound_ms(rkvw[0], s0)
    row = {"name": "wkv6", "shape": list(RWKV_SHAPE), "dtype": "bfloat16",
           "max_abs_err": errs[torch.bfloat16][0],
           "max_abs_err_state": errs[torch.bfloat16][1],
           "max_abs_err_f32": errs[torch.float32][0],
           "kernel_ms": kernel_ms, "kernel_burst_ms": burst_ms(kernel),
           "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
           "bytes": nbytes, "gbytes_per_s": nbytes / kernel_ms / 1e6}
    log("kernels", "rwkv6-3b prefill shape " + json.dumps(row))
    return row


def phase_ssd():
    from repro_torch.kernels.ssm_scan.chunked import ssm_scan_chunked
    from repro_torch.kernels.ssm_scan.kernel import ssm_scan

    def check(name, args, h0, chunk, tol):
        y, hT = ssm_scan(*args, h0=h0)
        want_y, want_h = ssm_scan_chunked(*args, h0=h0, chunk=chunk)
        torch.cuda.synchronize()
        err_y = (y.float() - want_y.float()).abs().max().item()
        err_h = (hT - want_h).abs().max().item()
        log("kernels", f"ssm_scan {name}: max_abs_err y {err_y:.3e} state "
            f"{err_h:.3e} (max |y| {want_y.float().abs().max().item():.3g}, "
            f"limit rtol = atol = {tol})")
        assert torch.isfinite(y).all() and torch.isfinite(hT).all()
        torch.testing.assert_close(y.float(), want_y.float(), rtol=tol,
                                   atol=tol)
        torch.testing.assert_close(hT, want_h, rtol=tol, atol=tol)
        return err_y, err_h

    for dtype in (torch.float32, torch.bfloat16):
        for i, (name, shape, chunk, state, dt_scale) in enumerate(
                SSD_VARIANTS):
            args, h0 = rand_ssd(shape, dtype, seed=i, state=state,
                                dt_scale=dt_scale)
            check(f"{name} {str(dtype)[6:]} shape {shape} chunk {chunk}",
                  args, h0, chunk, SSD_TOL[dtype])

    errs = {}
    B, _, H, P, _, N = ZAMBA_SSD_SHAPE
    for dtype in (torch.float32, torch.bfloat16):
        args, _ = rand_ssd(ZAMBA_SSD_SHAPE, dtype, seed=100, state=False)
        h0 = torch.zeros(B, H, P, N, device="cuda")   # the serve path's
        errs[dtype] = check(f"zamba2-2.7b {str(dtype)[6:]} shape "
                            f"{ZAMBA_SSD_SHAPE}", args, h0, 256,
                            SSD_TOL[dtype])
    def kernel():
        return ssm_scan(*args, h0=h0)
    kernel_ms = time_ms(kernel)
    plain_ms = time_ms(lambda: ssm_scan_chunked(*args, h0=h0, chunk=256))
    bound_ms, bound_by, flops, nbytes = ssd_bound_ms(args[0], args[3], h0)
    row = {"name": "ssm_scan", "shape": list(ZAMBA_SSD_SHAPE),
           "dtype": "bfloat16", "max_abs_err": errs[torch.bfloat16][0],
           "max_abs_err_state": errs[torch.bfloat16][1],
           "max_abs_err_f32": errs[torch.float32][0],
           "kernel_ms": kernel_ms, "kernel_burst_ms": burst_ms(kernel),
           "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
           "bytes": nbytes, "gbytes_per_s": nbytes / kernel_ms / 1e6}
    log("kernels", "zamba2-2.7b prefill shape " + json.dumps(row))
    return row


def phase_gemm():
    from repro_torch.kernels.gemm.kernel import matmul
    from repro_torch.kernels.gemm.ref import matmul_ref

    def operands(shape, dtype, seed, w_scale=1.0):
        m, k, n = shape
        g = torch.Generator(device="cuda").manual_seed(seed)
        a = torch.randn(m, k, generator=g, device="cuda").to(dtype)
        b = (w_scale * torch.randn(k, n, generator=g, device="cuda")
             ).to(dtype)
        return a, b

    def check(name, a, b, dtype, tol=None):
        got, want = matmul(a, b), matmul_ref(a, b)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.isfinite(got).all()
        err = (got.float() - want.float()).abs().max().item()
        c_max = want.float().abs().max().item()
        tol = tol(c_max) if tol else GEMM_TOL[dtype]
        log("kernels", f"gemm {name} {str(dtype)[6:]}: max_abs_err "
            f"{err:.3e} (max |c| {c_max:.3g}, limit {tol})")
        torch.testing.assert_close(got.float(), want.float(), **tol)
        return err

    def timed(name, a, b, dtype, err):
        m, k = a.shape
        n = b.shape[1]
        kernel_ms = time_ms(lambda: matmul(a, b))
        bound_ms, bound_by, flops, nbytes = gemm_bound_ms(m, k, n, dtype)
        row = {"name": "gemm", "shape": [m, k, n],
               "dtype": str(dtype)[6:], "max_abs_err": err,
               "kernel_ms": kernel_ms,
               "plain_ms": time_ms(lambda: matmul_ref(a, b)),
               "library_ms": time_ms(lambda: torch.matmul(a, b)),
               "kernel_burst_ms": burst_ms(lambda: matmul(a, b)),
               "library_burst_ms": burst_ms(lambda: torch.matmul(a, b)),
               "library_kernels": device_breakdown(
                   lambda: torch.matmul(a, b))["top_ms"],
               "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
               "bytes": nbytes, "tflops": flops / kernel_ms / 1e9}
        log("kernels", f"gemm {name} " + json.dumps(row))
        return row

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for i, shape in enumerate(GEMM_SHAPES):
            a, b = operands(shape, dtype, seed=i)
            errs[shape, dtype] = check(f"shape {shape}", a, b, dtype)
    a, b = operands(GEMM_CALIB_SHAPE, torch.float32,
                    seed=GEMM_SHAPES.index(GEMM_CALIB_SHAPE))
    row = timed("calibration shape", a, b, torch.float32,
                errs[GEMM_CALIB_SHAPE, torch.float32])
    in_proj_tol = {torch.float32: None, torch.bfloat16: lambda c_max: dict(
        rtol=IN_PROJ_BF16_RTOL, atol=2 * 2 ** -8 * c_max)}
    for dtype in (torch.float32, torch.bfloat16):
        a, b = operands(IN_PROJ_SHAPE, dtype, seed=100,
                        w_scale=IN_PROJ_SHAPE[1] ** -0.5)
        err = check(f"zamba2-2.7b in_proj shape {IN_PROJ_SHAPE}", a, b,
                    dtype, in_proj_tol[dtype])
        timed("zamba2-2.7b in_proj shape", a, b, dtype, err)
    del a, b
    torch.cuda.empty_cache()
    return row


def phase_calibrate_plan():
    """The calibration pass on the card, the store round trip, and the
    planner on the calibrated and the data-sheet constants."""
    from repro_torch.configs import get_config
    from repro_torch.core.evaluator import EvalOptions, Evaluator
    from repro_torch.kernels.calibrate import (load_profile, profile_kernels,
                                               save_profile)
    from repro_torch.sharding.mcm_planner import arch_to_task, gpu_hw, plan

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    prof = profile_kernels()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    log("calibrate", f"profile_kernels() in {wall:.2f}s on {prof.backend}; "
        f"launches {counts}")
    assert counts == CALIB_LAUNCHES, (counts, CALIB_LAUNCHES)
    assert prof.backend == "cuda"
    for smp in prof.samples:
        row = {"kernel": smp.kernel, "shape": list(smp.shape),
               "flops": smp.flops, "bytes": smp.ideal_bytes,
               "wall_ms": 1e3 * smp.wall_s,
               "tflops": smp.achieved_flops_per_s / 1e12,
               "gbytes_per_s": smp.achieved_bytes_per_s / 1e9}
        log("calibrate", "sample " + json.dumps(row))
        assert smp.flops > 0 and smp.wall_s > 0, smp
    # f32 GEMM samples: no faster than the f32 CUDA-core peak (5% for
    # clock boost and timer grain).
    assert 0 < prof.flops_per_s <= 1.05 * H100_F32_FLOPS, prof.flops_per_s
    share = prof.bytes_per_s / H100_BYTES_PER_S
    log("calibrate", json.dumps({
        "flops_per_s": prof.flops_per_s, "bytes_per_s": prof.bytes_per_s,
        "bytes_share_of_hbm_peak": share,
        "byte_overhead": prof.byte_overhead, "nop_frac": prof.nop_frac,
        "freq_hz_at_128x128": prof.freq_for(128, 128)}))
    path = ROOT / "build" / "calibrated_hw.bin"
    save_profile(prof, str(path))
    assert load_profile(str(path)) == prof, "profile changed in the store"
    log("calibrate", f"profile saved to {path.relative_to(ROOT)} and "
        "loaded back equal")

    seq, batch, min_layers = 512, 8, 2          # planner_validate's slice
    for arch in SERVED:
        cfg = get_config(arch)
        per = cfg.hybrid_attn_period or cfg.local_global_period or 1
        layers = per * max(1, -(-min_layers // per))
        for mesh in ((1, 1), (2, 2)):
            for label, profile in (("calibrated", prof), ("datasheet", None)):
                t0 = time.perf_counter()
                pr = plan(cfg, mesh, seq, batch, layers=layers, ga_budget=10,
                          profile=profile)
                row = {"arch": arch, "mesh": list(mesh), "layers": layers,
                       "constants": label,
                       "baseline_s": pr.baseline_latency,
                       "optimized_s": pr.optimized_latency,
                       "headroom": pr.nonuniform_headroom,
                       "modeled_speedup": pr.modeled_speedup,
                       "accum_steps": pr.knobs["accum_steps"],
                       "plan_s": time.perf_counter() - t0}
                log("plan", json.dumps(row))
                for key in ("baseline_latency", "optimized_latency",
                            "nonuniform_headroom"):
                    v = getattr(pr, key)
                    assert math.isfinite(v) and v > 0, (key, row)
                assert pr.nonuniform_headroom >= 1.0, row
                task = arch_to_task(cfg, seq, batch, layers=layers)
                valid = Evaluator(task, gpu_hw(mesh), EvalOptions(
                    redistribution=True)).chain_valid
                assert np.all(pr.redist_mask <= valid), row
                assert batch % pr.knobs["accum_steps"] == 0, row
                assert pr.knobs["shard_residual"] == bool(
                    pr.redist_mask.any()), row
    return counts


def _wrappers():
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.gemm.kernel import matmul
    from repro_torch.kernels.netsim.kernel import waterfill
    from repro_torch.kernels.rwkv6.kernel import wkv6
    from repro_torch.kernels.sgs.kernel import sgs_batch
    from repro_torch.kernels.ssm_scan.kernel import ssm_scan
    return {"flash_attention": flash_attention, "wkv6": wkv6,
            "ssm_scan": ssm_scan, "gemm": matmul, "sgs_batch": sgs_batch,
            "netsim_waterfill": waterfill}


def reset_launch_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def launch_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def phase_serve():
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import blockwise, ops
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
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts["flash_attention"]
    peak = torch.cuda.max_memory_allocated()

    assert launches == cfg.n_layers * n_waves, (
        f"flash_attention launched {launches} times, expected "
        f"{cfg.n_layers} layers x {n_waves} prefill waves")
    assert counts["wkv6"] == counts["ssm_scan"] == counts["gemm"] == 0, counts
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
    return counts


def phase_serve_rwkv6():
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6 import ops
    from repro_torch.kernels.rwkv6.chunked import wkv6_chunked
    from repro_torch.models import forward, init_caches, init_model
    from repro_torch.serve import ServeEngine

    cfg = get_config("rwkv6-3b")
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    engine = ServeEngine(cfg, model, batch_size=4, device="cuda")
    rng = np.random.default_rng(0)
    lengths = rng.integers(900, 1025, 8)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    new_tokens = 16
    n_waves = math.ceil(len(prompts) / engine.B)
    log("serve", f"{cfg.name}: {n_params} parameters ({cfg.dtype}, drawn "
        f"in {init_s:.1f}s), {len(prompts)} requests, prompt lengths "
        f"{lengths.tolist()}, {n_waves} waves of {engine.B}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts["wkv6"]
    peak = torch.cuda.max_memory_allocated()

    assert launches == cfg.n_layers * n_waves, (
        f"wkv6 launched {launches} times, expected {cfg.n_layers} layers "
        f"x {n_waves} prefill waves")
    assert counts["flash_attention"] == counts["ssm_scan"] == 0, counts
    assert counts["gemm"] == 0, counts
    assert len(outs) == len(prompts)
    assert all(len(o) == new_tokens for o in outs)
    assert all(0 <= t < cfg.vocab_size for o in outs for t in o)

    # First wave: prefill and one decode step with the kernel, against
    # the same with the plain chunked WKV, on the bf16 model that served
    # and on the same seeded weights in f32.
    toks = torch.from_numpy(engine.pad_wave(prompts[:engine.B])).cuda()
    step = torch.tensor([o[0] for o in outs[:engine.B]], device="cuda")
    step = step[:, None]
    capacity = engine.capacity

    versions = {f"plain{c}": with_chunk(wkv6_chunked, c) for c in (32, 16)}

    def compare(m, c):
        return compare_paths(m, c, toks, step, capacity, (ops, "wkv6"),
                             versions, lambda caches: caches["layers"]["wkv"])
    bf16 = compare(model, cfg)
    check_paths(cfg, bf16, True, "plain32", "WKV")

    # Where a warm prefill of the first wave and one decode step after it
    # spend their time.
    with torch.inference_mode():
        caches = init_caches(cfg, engine.B, engine.capacity)
        prefill = device_breakdown(lambda: forward(
            model, {"tokens": toks}, mode="prefill", caches=caches))
        decode = device_breakdown(lambda: forward(
            model, {"tokens": step}, mode="decode", caches=caches,
            pos=toks.shape[1]))
    log("serve", "profile prefill " + json.dumps(prefill))
    log("serve", "profile decode step " + json.dumps(decode))

    pre = engine.timings["prefill_s"]
    dec_s = engine.timings["decode_s"]
    gen_tokens = sum(len(o) for o in outs)
    row = {"arch": cfg.name, "requests": len(prompts),
           "prompt_tokens": int(lengths.sum()), "new_tokens": new_tokens,
           "waves": n_waves, "wkv6_launches": launches,
           "prefill_ms": [1e3 * s for s in pre],
           "decode_ms_per_token": 1e3 * statistics.median(dec_s),
           "wall_s": wall, "tokens_per_s": gen_tokens / wall,
           "prompt_tokens_per_s": int(lengths.sum()) / sum(pre),
           "max_memory_allocated_bytes": peak,
           "first_tokens": outs[0][:8]}
    log("serve", json.dumps(row))

    del engine, model, bf16
    torch.cuda.empty_cache()
    cfg32 = cfg.replace(dtype="float32")
    model32 = init_model(cfg32, seed=0, device="cuda")
    check_paths(cfg32, compare(model32, cfg32), False, "plain32", "WKV")
    return counts


def with_chunk(plain, size):
    """``plain`` at chunk ``size``, called as the layer calls its op."""
    return lambda *args, chunk=None, **kw: plain(*args, chunk=size, **kw)


def compare_paths(model, cfg, toks, step, capacity, op, versions, states):
    """Prefill logits, the recurrent states that prefill leaves and the
    logits of one decode step after it, with the kernel ("kernel") and
    with each of ``versions`` (label -> a plain version called as the op
    is). ``op`` is the (module, name) of the public op the layer calls,
    ``states`` a function of the caches giving the states."""
    from repro_torch.models import forward, init_caches

    module, name = op
    kernel_op = getattr(module, name)
    out = {}
    with torch.inference_mode():
        for label, fn in [("kernel", kernel_op), *versions.items()]:
            caches = init_caches(cfg, toks.shape[0], capacity)
            setattr(module, name, fn)
            try:
                logits, _ = forward(model, {"tokens": toks}, mode="prefill",
                                    caches=caches)
            finally:
                setattr(module, name, kernel_op)
            st = states(caches).clone()
            dec, _ = forward(model, {"tokens": step}, mode="decode",
                             caches=caches, pos=toks.shape[1])
            out[label] = {"prefill logits": logits.float(), "states": st,
                          "decode-step logits": dec.float()}
    return out


def check_paths(cfg, out, spread, ref, what):
    """Kernel against the plain version ``ref`` for each output, within
    its limit times its largest magnitude. With ``spread`` (bf16) the
    limit is the larger of that and twice the largest distance from
    ``ref`` of the other plain versions in ``out``: a bf16 model of
    random weights carries a one-step rounding difference on through
    every layer and 1024 steps, whatever version sums in which order."""
    limits = {"prefill logits": LOGIT_REL_TOL,
              "states": STATE_REL_TOL if spread else STATE_REL_TOL_F32,
              "decode-step logits": LOGIT_REL_TOL}
    alts = [k for k in out if k not in ("kernel", ref)]
    for key, rel in limits.items():
        got, want = out["kernel"][key], out[ref][key]
        name = f"{what} states" if key == "states" else key
        assert torch.isfinite(got).all(), f"non-finite {name}"
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        alt_err = {a: (out[a][key] - want).abs().max().item() for a in alts}
        limit = (max(rel * scale, 2 * max(alt_err.values())) if spread
                 else rel * scale)
        msg = (f"{cfg.dtype} {name} kernel vs {ref}: max_abs_err "
               f"{err:.4e} of max |x| {scale:.4g} ({err / scale:.3e}); "
               + "; ".join(f"{a} vs {ref} {e:.4e}"
                           for a, e in alt_err.items())
               + f"; limit {limit:.4e}")
        if key != "states":
            agree = (got[:, -1].argmax(-1) == want[:, -1].argmax(-1))
            msg += f"; last-position argmax agreement {agree.float().mean():.2f}"
        log("serve", msg)
        assert err <= limit, msg


def phase_serve_zamba2():
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssm_scan import ops
    from repro_torch.kernels.ssm_scan.chunked import ssm_scan_chunked
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    from repro_torch.models import forward, init_caches, init_model
    from repro_torch.serve import ServeEngine

    cfg = get_config("zamba2-2.7b")
    n_groups = cfg.n_layers // cfg.hybrid_attn_period
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    engine = ServeEngine(cfg, model, batch_size=4, capacity=2048,
                         device="cuda")
    rng = np.random.default_rng(0)
    lengths = rng.integers(900, 1025, 8)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    new_tokens = 16
    n_waves = math.ceil(len(prompts) / engine.B)
    log("serve", f"{cfg.name}: {n_params} parameters ({cfg.dtype}, drawn "
        f"in {init_s:.1f}s), {len(prompts)} requests, prompt lengths "
        f"{lengths.tolist()}, {n_waves} waves of {engine.B}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    assert counts["ssm_scan"] == cfg.n_layers * n_waves, (
        f"ssm_scan launched {counts['ssm_scan']} times, expected "
        f"{cfg.n_layers} layers x {n_waves} prefill waves")
    assert counts["flash_attention"] == n_groups * n_waves, (
        f"flash_attention launched {counts['flash_attention']} times, "
        f"expected {n_groups} shared-attention groups x {n_waves} waves")
    assert counts["wkv6"] == counts["gemm"] == 0, counts
    assert len(outs) == len(prompts)
    assert all(len(o) == new_tokens for o in outs)
    assert all(0 <= t < cfg.vocab_size for o in outs for t in o)

    # First wave: prefill and one decode step with the kernel, against
    # the same with the plain chunked SSD, on the bf16 model that served
    # and on the same seeded weights in f32.
    toks = torch.from_numpy(engine.pad_wave(prompts[:engine.B])).cuda()
    step = torch.tensor([o[0] for o in outs[:engine.B]], device="cuda")
    step = step[:, None]
    # The plain version at the model's chunk is the reference; the same
    # at half the chunk and the sequential oracle (the recurrence, as the
    # kernel computes it) give the plain versions' own spread.
    ref = f"plain{cfg.ssm_chunk}"
    versions = {ref: with_chunk(ssm_scan_chunked, cfg.ssm_chunk),
                f"plain{cfg.ssm_chunk // 2}": with_chunk(
                    ssm_scan_chunked, cfg.ssm_chunk // 2),
                "oracle": lambda *args, chunk=None, **kw: ssm_scan_ref(
                    *args, **kw)}
    capacity = engine.capacity

    def compare(m, c):
        return compare_paths(m, c, toks, step, capacity, (ops, "ssm_scan"),
                             versions,
                             lambda caches: caches["mamba"]["ssm"])
    check_paths(cfg, compare(model, cfg), True, ref, "SSM")

    # Where a warm prefill of the first wave and one decode step after it
    # spend their time.
    with torch.inference_mode():
        caches = init_caches(cfg, engine.B, engine.capacity)
        prefill = device_breakdown(lambda: forward(
            model, {"tokens": toks}, mode="prefill", caches=caches))
        decode = device_breakdown(lambda: forward(
            model, {"tokens": step}, mode="decode", caches=caches,
            pos=toks.shape[1]))
    log("serve", "profile prefill " + json.dumps(prefill))
    log("serve", "profile decode step " + json.dumps(decode))

    pre = engine.timings["prefill_s"]
    dec_s = engine.timings["decode_s"]
    gen_tokens = sum(len(o) for o in outs)
    row = {"arch": cfg.name, "requests": len(prompts),
           "prompt_tokens": int(lengths.sum()), "new_tokens": new_tokens,
           "waves": n_waves, "ssm_scan_launches": counts["ssm_scan"],
           "flash_launches": counts["flash_attention"],
           "prefill_ms": [1e3 * s for s in pre],
           "decode_ms_per_token": 1e3 * statistics.median(dec_s),
           "wall_s": wall, "tokens_per_s": gen_tokens / wall,
           "prompt_tokens_per_s": int(lengths.sum()) / sum(pre),
           "max_memory_allocated_bytes": peak,
           "first_tokens": outs[0][:8]}
    log("serve", json.dumps(row))

    del engine, model, caches
    torch.cuda.empty_cache()
    cfg32 = cfg.replace(dtype="float32")
    model32 = init_model(cfg32, seed=0, device="cuda")
    check_paths(cfg32, compare(model32, cfg32), False, ref, "SSM")
    return counts


# The model zoo's serve phases (phase 5, after zamba2-2.7b): arch ->
# (layers served, or None for all; groups of requests as (shortest,
# longest + 1, count) prompt tokens). The engine runs waves of 4 in
# order: gemma2-2b's last wave holds 2 prompts past its 4096-token
# window, so the local layers' window masks in the kernel and their ring
# buffers wrap. mixtral-8x22b's 141B parameters do not fit one 80 GB card
# in bf16: 4 of its 56 layers (~20 GB) serve at the published width; so
# do 4 of deepseek-v2-236b's 60 (~27 GB: its dense first layer and 3 MoE
# layers of 160 experts, 7.55 GB each). pixtral-12b serves text prompts
# (the engine feeds tokens), then takes the patch path (pixtral_patches).
ZOO_SERVED = {
    "internlm2-20b": (None, ((900, 1025, 4),)),
    "gemma2-2b": (None, ((900, 1025, 8), (4200, 4601, 2))),
    "minicpm3-4b": (None, ((900, 1025, 8),)),
    "mixtral-8x22b": (4, ((900, 1025, 4),)),
    "deepseek-v2-236b": (4, ((900, 1025, 4),)),
    "pixtral-12b": (None, ((900, 1025, 4),)),
}
ZOO_NEW_TOKENS = 16
ZOO_LONG_TAIL = 256     # gemma2's long wave: logits compared at the last
# Each layer's attention, kernel against plain on the inputs it was given
# in the served model, element by element: within ATTN_RTOL (one bf16
# step) of |out| plus ATTN_ATOL_RMS_V times the RMS of the layer's values
# v (past head dim 128 the kernel rounds each weight to bf16, an error of
# up to 2^-9 of each weighted v, which shows where they cancel; the
# largest |out|, in the early causal rows, would be no scale of it). On
# the H100 the kernel's worst layer reads 3.42e-3 of RMS |v| beyond rtol
# (minicpm3-4b; up to head dim 128, where P is split, 2e-6) and the
# least planted fault 1.13e-2; the limit sits between them, 1.75x and
# 1.88x from each (PERF.md), and every layer's planted faults must
# exceed it.
ATTN_RTOL = 1e-2
ATTN_ATOL_RMS_V = 6e-3
# The prefill logits, kernel against plain, within the larger of
# LOGIT_REL_TOL of the largest |logit| and LOGIT_SPREAD_FACTOR times the
# plain version's own spread (at half its chunks): through 26-62 bf16
# layers of random weights a one-step rounding of an attention output
# grows, for the kernel and for the plain version in another order
# alike. On the H100 the held models' kernel distance is at most 1.122
# times the spread (internlm2-20b; mixtral-8x22b's and deepseek-v2's,
# reported, 1.33 and 1.15; PERF.md), so 1.25 leaves a margin of ~11%.
# hubert-xlarge's 48 non-causal layers read 1.35 while the kernel rounded
# P to bf16 at head dim 80; with P split into hi + lo there (heads up to
# 128) they read 1.00-1.01.
LOGIT_SPREAD_FACTOR = 1.25


def _plain(scale=1):
    """The plain blockwise attention, at the model's chunks divided by
    ``scale``, called as the layers call ops.attention."""
    from repro_torch.kernels.flash_attention import blockwise

    def attention(q, k, v, q_chunk, kv_chunk, **kw):
        return blockwise.blockwise_attention(
            q, k, v, q_chunk=q_chunk // scale, kv_chunk=kv_chunk // scale,
            **kw)
    return attention


def _batch_len(batch):
    """Positions a forward over ``batch`` produces: patches + tokens, or
    frames."""
    return sum(batch[n].shape[1] for n in ("patches", "tokens", "frames")
               if n in batch)


def _prefill(model, cfg, batch, capacity, attention=None, tail=None):
    """Prefill logits over the real vocabulary (of the last ``tail``
    positions) of ``batch`` with the kernel, or with ``attention`` in its
    place; an encoder's forward (mode "train", no cache) in place of a
    prefill."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import forward, init_caches

    kernel_attention = ops.attention
    ops.attention = attention or kernel_attention
    B = next(iter(batch.values())).shape[0]
    try:
        with torch.inference_mode():
            if cfg.is_encoder:
                logits, _ = forward(model, batch, mode="train")
            else:
                logits, _ = forward(model, batch, mode="prefill",
                                    caches=init_caches(cfg, B, capacity))
    finally:
        ops.attention = kernel_attention
    if tail:
        logits = logits[:, -tail:]
    return logits[..., :cfg.vocab_size].float()


def check_zoo_prefill(model, cfg, batch, capacity, what, tail=None):
    """One prefill of ``batch`` (an encoder: its forward) with the
    kernel, capturing every layer's attention
    inputs, one with the plain attention and one with the plain attention
    at half its chunks. (1) Each layer's attention, kernel against plain
    on its captured inputs, element by element within ATTN_RTOL and
    ATTN_ATOL_RMS_V; the same limit must reject the layer's planted
    faults.
    (2) The logits, kernel against plain, within LOGIT_REL_TOL of the
    largest |logit| or, where larger, LOGIT_SPREAD_FACTOR times the
    plain version's own spread. With MoE the logits are reported, not
    held: a bf16 difference flips near-ties of the routers; the share of
    (token, k) routes whose expert differs between the kernel's run and
    the plain one, and the routes the capacity path drops, are reported.
    Returns the kernel's logits."""
    from repro_torch.kernels.flash_attention import blockwise, ops

    kernel_attention = ops.attention
    captured, run = [], ["kernel"]
    routes = {"kernel": [], "plain": [], "half": []}

    def capture(q, k, v, **kw):
        captured.append((q.clone(), k.clone(), v.clone(), kw))
        return kernel_attention(q, k, v, **kw)

    def recorder(orig):
        def route(xg, T, *args):
            out = orig(xg, T, *args)
            sel, ranks, C = out[2][:T], out[3][:T], out[4]
            routes[run[0]].append((sel.clone(), ranks < C))
            return out
        return route
    moes = [blk.moe for blk in model.blocks if getattr(blk, "is_moe", False)]
    for m in moes:
        m.route = recorder(m.route)
    try:
        got = _prefill(model, cfg, batch, capacity, capture, tail)
        run[0] = "plain"
        want = _prefill(model, cfg, batch, capacity, _plain(), tail)
        run[0] = "half"
        alt = _prefill(model, cfg, batch, capacity, _plain(2), tail)
    finally:
        for m in moes:
            del m.route         # back to the class's method
    assert torch.isfinite(got).all(), "non-finite prefill logits"
    assert got.shape == (next(iter(batch.values())).shape[0],
                         tail or _batch_len(batch), cfg.vocab_size)
    assert len(captured) == cfg.n_layers
    layers = []
    for q, k, v, kw in captured:
        with torch.inference_mode():
            a = kernel_attention(q, k, v, **kw)
            b = blockwise.blockwise_attention(q, k, v, **kw)
            rms = v.float().pow(2).mean().sqrt().item()
            faults = planted_faults(q, k, v, kw, b, ATTN_RTOL)
            layers.append({"beyond": excess(a, b, ATTN_RTOL) / rms,
                           **{n: e / rms for n, e in faults.items()}})
    del captured, a, b
    # The worst layer of each reading: the largest for the kernel and
    # the control, the smallest for each planted fault.
    names = dict.fromkeys(n for r in layers for n in r)
    summary = {n: (max if n in ("beyond", "dense") else min)(
        (r[n], i) for i, r in enumerate(layers) if n in r) for n in names}
    log("serve", f"{cfg.name} {what}: each layer's attention, kernel vs "
        f"plain on its captured inputs, beyond rtol {ATTN_RTOL} in RMS "
        f"|v| (limit {ATTN_ATOL_RMS_V}), worst layer: "
        + ", ".join(f"{'kernel' if n == 'beyond' else n} {e:.3e} (layer "
                    f"{i})" for n, (e, i) in summary.items()))
    for i, r in enumerate(layers):
        assert r["beyond"] <= ATTN_ATOL_RMS_V, (
            f"{cfg.name} {what} layer {i} attention: kernel vs plain "
            f"{r['beyond']:.3e} RMS |v| beyond rtol on its captured "
            "inputs")
        hold_planted({n: e for n, e in r.items() if n != "beyond"},
                     ATTN_ATOL_RMS_V, f"{cfg.name} {what} layer {i}")
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    spread = (alt - want).abs().max().item()
    agree = (got[:, -1].argmax(-1) == want[:, -1].argmax(-1)).float().mean()
    limit = max(LOGIT_REL_TOL * scale, LOGIT_SPREAD_FACTOR * spread)
    msg = (f"{cfg.name} {what} prefill logits kernel vs plain: max_abs_err "
           f"{err:.4f} of max |logit| {scale:.2f} ({err / scale:.3e}); "
           f"plain at half chunks vs plain {spread:.4f} "
           f"({spread / scale:.3e}); kernel / spread "
           f"{err / spread if spread else float('nan'):.3f}; "
           f"last-position argmax agreement "
           f"{agree.item():.2f}")
    if not moes:
        log("serve", msg + f"; limit {limit:.4f}")
        assert err <= limit, msg
        return got
    log("serve", msg + " (reported, not held: routing flips)")
    assert len(routes["kernel"]) == len(routes["plain"]) == len(moes)
    dropped = 0
    for i, ((ks, kk), (ps, _)) in enumerate(zip(routes["kernel"],
                                                routes["plain"])):
        T, K = ks.shape
        differ = ~(ks[:, :, None] == ps[:, None, :]).any(-1)
        row = {"layer": i, "routes": T * K,
               "routes_differ_share": differ.float().mean().item(),
               "dropped_routes": int((~kk).sum()),
               "tokens_dropped_entirely": int((~kk).all(-1).sum())}
        log("serve", f"{cfg.name} MoE routing, kernel vs plain attention "
            + json.dumps(row))
        dropped += row["dropped_routes"]
    assert dropped > 0, "the capacity path dropped no route"
    return got


def phase_serve_zoo(arch):
    """One of the model zoo's text decoders at its published width
    through ServeEngine: launch counts, the kernel against the plain
    attention on the first wave, a profiled prefill and decode step."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_caches, init_model
    from repro_torch.serve import ServeEngine

    layers, groups = ZOO_SERVED[arch]
    full = get_config(arch)
    cfg = full if layers is None else full.replace(n_layers=layers)
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(0)
    lengths = np.concatenate([rng.integers(lo, hi, n) for lo, hi, n in groups])
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    capacity = max(2048, int(lengths.max()) + ZOO_NEW_TOKENS)
    engine = ServeEngine(cfg, model, batch_size=4, capacity=capacity,
                         device="cuda")
    n_waves = math.ceil(len(prompts) / engine.B)
    cut = ("" if layers is None else
           f" (depth cut: {layers} of {full.n_layers} layers, because its "
           f"{full.n_layers}-layer weights do not fit one 80 GB card in "
           "bf16; widths as published)")
    log("serve", f"{cfg.name}: {n_params} parameters ({cfg.dtype}, drawn "
        f"in {init_s:.1f}s){cut}, {len(prompts)} requests, prompt lengths "
        f"{lengths.tolist()}, {n_waves} waves of up to {engine.B}, "
        f"capacity {capacity}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=ZOO_NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts["flash_attention"]
    peak = torch.cuda.max_memory_allocated()

    assert launches == cfg.n_layers * n_waves, (
        f"flash_attention launched {launches} times, expected "
        f"{cfg.n_layers} layers x {n_waves} prefill waves")
    assert counts["wkv6"] == counts["ssm_scan"] == counts["gemm"] == 0, counts
    assert len(outs) == len(prompts)
    assert all(len(o) == ZOO_NEW_TOKENS for o in outs)
    assert all(0 <= t < cfg.vocab_size for o in outs for t in o)

    toks = torch.from_numpy(engine.pad_wave(prompts[:engine.B])).cuda()
    check_zoo_prefill(model, cfg, {"tokens": toks}, capacity, "first wave")
    if len(groups) > 1:     # gemma2's long wave, past the window
        long = torch.from_numpy(engine.pad_wave(
            prompts[-groups[-1][2]:])).cuda()
        check_zoo_prefill(model, cfg, {"tokens": long}, capacity,
                          f"long wave (last {ZOO_LONG_TAIL} positions)",
                          tail=ZOO_LONG_TAIL)

    # Where a warm prefill of the first wave and one decode step after it
    # spend their time.
    with torch.inference_mode():
        caches = init_caches(cfg, engine.B, capacity)
        prefill = device_breakdown(lambda: forward(
            model, {"tokens": toks}, mode="prefill", caches=caches))
        step = torch.tensor([o[0] for o in outs[:engine.B]],
                            device="cuda")[:, None]
        decode = device_breakdown(lambda: forward(
            model, {"tokens": step}, mode="decode", caches=caches,
            pos=toks.shape[1]))
    log("serve", "profile prefill " + json.dumps(prefill))
    log("serve", "profile decode step " + json.dumps(decode))

    pre = engine.timings["prefill_s"]
    dec = engine.timings["decode_s"]
    gen_tokens = sum(len(o) for o in outs)
    row = {"arch": cfg.name, "layers": cfg.n_layers,
           "parameters": n_params, "requests": len(prompts),
           "prompt_tokens": int(lengths.sum()),
           "new_tokens": ZOO_NEW_TOKENS, "waves": n_waves,
           "flash_launches": launches,
           "prefill_ms": [1e3 * s for s in pre],
           "decode_ms_per_token": 1e3 * statistics.median(dec),
           "wall_s": wall, "tokens_per_s": gen_tokens / wall,
           "prompt_tokens_per_s": int(lengths.sum()) / sum(pre),
           "max_memory_allocated_bytes": peak,
           "prefill_busy_share": prefill["busy_share"],
           "decode_busy_share": decode["busy_share"],
           "first_tokens": outs[0][:8], "card": CARD}
    log("serve", json.dumps(row))
    del caches
    if arch in ZOO_EXTRA:
        counts = collections.Counter(counts)
        counts.update(ZOO_EXTRA[arch](model, cfg, engine))
    del engine, model
    torch.cuda.empty_cache()
    return counts


# pixtral-12b's patch path, through forward: a wave of 4 requests, each
# frontend_tokens (1024) patch embeddings of width frontend_dim (1024)
# followed by PATCH_TEXT text tokens (left-padded as the engine pads),
# prefilled into a cache of patches + text + PATCH_DECODE_STEPS, then
# PATCH_DECODE_STEPS greedy decode steps at positions past the patches.
PATCH_TEXT = (512, 1025)
PATCH_DECODE_STEPS = 8


def pixtral_patches(model, cfg, engine):
    """The patch path's prefill and decode (launch counts: one flash
    launch a layer), its loss mask against its definition (False over
    the patches, True over the text) and its positions, the kernel
    against the plain attention on its prefill (check_zoo_prefill)."""
    from repro_torch.models import forward, init_caches
    from repro_torch.models.transformer import embed_inputs

    rng = np.random.default_rng(1)
    B, Np, V = engine.B, cfg.frontend_tokens, cfg.vocab_size
    lengths = rng.integers(*PATCH_TEXT, B)
    toks = torch.from_numpy(engine.pad_wave(
        [rng.integers(0, V, n) for n in lengths])).cuda()
    g = torch.Generator(device="cuda").manual_seed(1)
    patches = torch.randn(B, Np, cfg.frontend_dim, generator=g,
                          device="cuda").to(torch.bfloat16)
    batch = {"tokens": toks, "patches": patches}
    S = toks.shape[1]
    capacity = Np + S + PATCH_DECODE_STEPS
    with torch.inference_mode():
        x, positions, loss_mask = embed_inputs(model, batch, "prefill")
    assert x.shape == (B, Np + S, cfg.d_model)
    assert torch.equal(positions[0].cpu(), torch.arange(Np + S))
    assert loss_mask.shape == (B, Np + S), loss_mask.shape
    assert not loss_mask[:, :Np].any() and loss_mask[:, Np:].all(), (
        "loss_mask is not False over the patches and True over the text")
    del x

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    decode_s = []
    with torch.inference_mode():
        t0 = time.perf_counter()
        caches = init_caches(cfg, B, capacity)
        logits, _ = forward(model, batch, mode="prefill", caches=caches)
        tok = logits[:, -1, :V].argmax(-1)[:, None]
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        assert logits.shape == (B, Np + S, cfg.padded_vocab)
        assert torch.isfinite(logits[..., :V]).all()
        for i in range(PATCH_DECODE_STEPS):
            t0 = time.perf_counter()
            step, _ = forward(model, {"tokens": tok}, mode="decode",
                              caches=caches, pos=Np + S + i)
            tok = step[:, -1, :V].argmax(-1)[:, None]
            torch.cuda.synchronize()
            decode_s.append(time.perf_counter() - t0)
            assert step.shape == (B, 1, cfg.padded_vocab)
            assert torch.isfinite(step[..., :V]).all()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    assert counts["flash_attention"] == cfg.n_layers, (
        f"patch prefill: flash launched {counts['flash_attention']} times "
        f"for {cfg.n_layers} layers")
    assert sum(counts.values()) == counts["flash_attention"], counts
    del caches, logits
    check_zoo_prefill(model, cfg, batch, capacity, "patch prefill")
    row = {"arch": cfg.name, "path": "patch prefill + decode",
           "requests": B, "patches": Np, "text_tokens": lengths.tolist(),
           "positions": Np + S, "capacity": capacity,
           "flash_launches": counts["flash_attention"],
           "prefill_ms": 1e3 * prefill_s,
           "decode_ms_per_token": 1e3 * statistics.median(decode_s),
           "max_memory_allocated_bytes": peak, "card": CARD}
    log("serve", json.dumps(row))
    return counts


ZOO_EXTRA = {"pixtral-12b": pixtral_patches}

# hubert-xlarge's encoder at its published width, all 48 layers: 4 clips
# of 30 s (1500 frames at 20 ms; S = 1500 leaves the kernel's last 64-key
# tile ragged), frontend_dim-wide frame embeddings from seed 0, once
# unmasked and once masked as in HuBERT's pre-training: spans of
# MASK_SPAN frames starting at MASK_PROB of the frames (arXiv:2106.07447).
HUBERT_CLIPS = 4
HUBERT_FRAMES = 1500
MASK_PROB = 0.08
MASK_SPAN = 10


def span_mask(rng, clips, frames):
    """HuBERT's span mask: round(MASK_PROB · frames) starts drawn
    without replacement per clip, each masking MASK_SPAN frames."""
    mask = np.zeros((clips, frames), bool)
    for b in range(clips):
        for s0 in rng.choice(frames - MASK_SPAN + 1,
                             round(MASK_PROB * frames), replace=False):
            mask[b, s0:s0 + MASK_SPAN] = True
    return mask


def phase_encoder_zoo():
    """hubert-xlarge through forward(mode="train"), no grad: each pass's
    launch counts (one flash launch a layer, non-causal), finite logits
    of the right shape, the kernel against the plain attention layer by
    layer and on the logits (check_zoo_prefill), a profiled pass, peak
    memory; a prefill is refused, as the JAX package's fails."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_model
    from repro_torch.serve import ServeEngine

    cfg = get_config("hubert-xlarge")
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    g = torch.Generator(device="cuda").manual_seed(0)
    frames = torch.randn(HUBERT_CLIPS, HUBERT_FRAMES, cfg.frontend_dim,
                         generator=g, device="cuda")
    mask = torch.from_numpy(span_mask(np.random.default_rng(0),
                                      HUBERT_CLIPS, HUBERT_FRAMES)).cuda()
    log("encoder", f"{cfg.name}: {n_params} parameters ({cfg.dtype}, "
        f"drawn in {init_s:.1f}s), {cfg.n_layers} layers, {HUBERT_CLIPS} "
        f"clips of {HUBERT_FRAMES} frames; masked share "
        f"{mask.float().mean().item():.3f}")
    total = collections.Counter()
    for what, batch in (("no mask", {"frames": frames}),
                        ("span mask", {"frames": frames, "mask": mask})):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, caches = forward(model, batch, mode="train")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        assert counts["flash_attention"] == cfg.n_layers, counts
        assert sum(counts.values()) == counts["flash_attention"], counts
        assert caches is None
        assert logits.shape == (HUBERT_CLIPS, HUBERT_FRAMES,
                                cfg.padded_vocab)
        assert torch.isfinite(logits[..., :cfg.vocab_size]).all()
        del logits
        check_zoo_prefill(model, cfg, batch, None, what)
        with torch.inference_mode():
            prof = device_breakdown(lambda: forward(model, batch,
                                                    mode="train"))
        row = {"arch": cfg.name, "pass": what, "layers": cfg.n_layers,
               "parameters": n_params, "clips": HUBERT_CLIPS,
               "frames": HUBERT_FRAMES,
               "flash_launches": counts["flash_attention"],
               "forward_ms": 1e3 * wall, "warm": prof,
               "frames_per_s": HUBERT_CLIPS * HUBERT_FRAMES / wall,
               "max_memory_allocated_bytes": peak, "card": CARD}
        log("encoder", json.dumps(row))
        total.update(counts)
    for refused in (lambda: forward(model, {"frames": frames[:, :8]},
                                    mode="prefill", caches={}),
                    lambda: ServeEngine(cfg, model, device="cuda")):
        try:
            refused()
        except ValueError as e:
            log("encoder", f"refused as JAX's: {e}")
        else:
            raise AssertionError(f"{cfg.name}: an encoder's prefill or "
                                 "serve engine was not refused")
    del model
    torch.cuda.empty_cache()
    return total


# Phase 6: the paper's front door. The lattice is held to the numpy
# backend by the tie contract: the objective within TIE_RTOL, and the
# partition equal or else, re-scored by the numpy evaluator, within
# TIE_RTOL of the numpy objective (mirrored share vectors score equal in
# numpy and may differ by an ulp on the card, where reductions sum in
# another order).
TIE_RTOL = 1e-9
CROSSOVER_POPULATIONS = (1, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def random_genomes(task, hw, pop, seed):
    """``pop`` sum-exact ViT genomes around the uniform partition (random
    unit moves of up to 8 rows/columns), random collectors, and
    redistribution on every chained pair."""
    from repro_torch.core.workload import uniform_partition
    rng = np.random.default_rng(seed)
    base = uniform_partition(task, hw.X, hw.Y)
    genomes = []
    for arr in (base.Px, base.Py):
        g = np.repeat(arr[None], pop, 0).astype(np.float64)
        P, n, X = g.shape
        d = rng.integers(0, X, (P, n))
        r = (d + rng.integers(1, X, (P, n))) % X
        take = np.take_along_axis(g, d[..., None], -1)[..., 0]
        move = np.minimum(take, rng.integers(0, 9, (P, n)))
        np.put_along_axis(g, d[..., None], (take - move)[..., None], -1)
        give = np.take_along_axis(g, r[..., None], -1)[..., 0]
        np.put_along_axis(g, r[..., None], (give + move)[..., None], -1)
        genomes.append(g)
    coll = rng.integers(0, hw.Y, (pop, len(task))).astype(np.float64)
    return genomes[0], genomes[1], coll


def scoring_breakdown(fn, calls_before):
    """One call of ``fn`` (a lattice solve on the card) under
    torch.profiler: host wall time, the device's busy time (kernels and
    copies) and share, kernels per scoring call, device copy time and the
    host's time blocked in copies and synchronisations per call."""
    from repro_torch.core import miqp_lattice
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    calls = miqp_lattice.solve_lattice_batch.score_calls - calls_before
    kernels = copies = 0
    kernel_us = copy_us = blocked_us = 0.0
    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith("Memcpy") or e.name.startswith("Memset"):
                copies += 1
                copy_us += e.self_device_time_total
            else:
                kernels += 1
                kernel_us += e.self_device_time_total
                by_name[e.name] += 1
        elif e.name in ("cudaMemcpyAsync", "cudaStreamSynchronize",
                        "cudaDeviceSynchronize", "cudaMemcpy"):
            blocked_us += e.cpu_time_total
    return {"wall_s": wall_us / 1e6, "scoring_calls": calls,
            "kernels_per_call": kernels / calls,
            "copies_per_call": copies / calls,
            "device_kernel_ms_per_call": kernel_us / 1e3 / calls,
            "device_copy_ms_per_call": copy_us / 1e3 / calls,
            "host_blocked_in_copy_or_sync_ms_per_call":
                blocked_us / 1e3 / calls,
            "device_busy_share": (kernel_us + copy_us) / wall_us,
            "top_kernels": by_name.most_common(4)}


def phase_optimize():
    """The paper's front door on the card: the quickstart's ViT-B/16 on a
    4x4 type-A HBM MCM, the four Table-3 schemes on the latency
    objective and pipelining at batch 8; the MIQP lattice's scoring on
    the card held to the numpy backend's solve; a profile of the card's
    solve; the AUTO_POPULATION_THRESHOLD crossover. No kernel of the port
    lies on this path: every launch count must stay 0."""
    from repro_torch.core import api, evaluator_torch, miqp_lattice
    from repro_torch.core.evaluator import (AUTO_POPULATION_THRESHOLD,
                                            EvalOptions, Evaluator)
    from repro_torch.core.hw import make_hw
    from repro_torch.core.miqp import MIQPConfig, run_miqp
    from repro_torch.core.workload import Partition
    from repro_torch.graphs import vit_task

    task = vit_task(batch=1)
    hw = make_hw("A", grid=4, memory="hbm")
    log("optimize", f"{task.name}: {len(task)} GEMMs, "
        f"{task.total_flops / 1e9:.1f} GFLOPs; "
        + hw.topology.describe().replace("\n", "; "))
    reset_launch_counts()
    results = {}
    for method in api.METHODS:
        calls = evaluator_torch.grid_evaluate.calls
        calls.clear()
        miqp_lattice.solve_lattice_batch.score_calls = 0
        r = api.optimize(task, hw, method, "latency",
                         miqp_config=MIQPConfig(time_limit=30))
        scored = miqp_lattice.solve_lattice_batch.score_calls
        results[method] = r
        log("optimize", json.dumps({
            "method": method, "latency_us": r.latency * 1e6, "edp": r.edp,
            "speedup_vs_baseline": r.speedup_vs_baseline,
            "solve_s": r.solve_seconds, "lattice_scoring_calls": scored,
            "torch_evaluator_calls": dict(calls)}))
        assert math.isfinite(r.latency) and r.latency > 0, method
        assert r.speedup_vs_baseline > 0, method
        if method == "miqp":
            # The default MIQPConfig scores every lattice chunk with the
            # torch evaluator, on the card.
            assert scored > 0 and dict(calls) == {"cuda": scored}, (
                scored, dict(calls))
    pipe = results["miqp"].pipeline(batch=8)
    log("optimize", f"miqp with cross-sample pipelining (batch 8): "
        f"{pipe.speedup:.4f}x ({pipe.pipelined * 1e6:.1f} us vs "
        f"{pipe.sequential * 1e6:.1f} us sequential, {pipe.engine})")
    assert 0 < pipe.pipelined <= pipe.sequential

    # The same MIQP solve scored on numpy: the tie contract.
    t0 = time.perf_counter()
    ref = api.optimize(task, hw, "miqp", "latency",
                       miqp_config=MIQPConfig(time_limit=30,
                                              backend="numpy"))
    numpy_s = time.perf_counter() - t0
    card = results["miqp"]
    same = (np.array_equal(card.partition.Px, ref.partition.Px)
            and np.array_equal(card.partition.Py, ref.partition.Py)
            and np.array_equal(card.partition.collectors,
                               ref.partition.collectors))
    rel = abs(card.latency - ref.latency) / ref.latency
    rescored = ref.latency
    if not same:
        ev = Evaluator(task, hw.replace(diagonal_links=True),
                       EvalOptions(redistribution=True, async_exec=True))
        rescored = ev.evaluate(Partition(card.partition.Px,
                                         card.partition.Py,
                                         card.partition.collectors),
                               card.redist_mask).latency
    log("optimize", json.dumps({
        "miqp_solve_s_torch_cuda": card.solve_seconds,
        "miqp_solve_s_numpy": ref.solve_seconds,
        "numpy_optimize_wall_s": numpy_s,
        "latency_us_torch_cuda": card.latency * 1e6,
        "latency_us_numpy": ref.latency * 1e6, "rel_diff": rel,
        "partition_equal": same, "card_partition_rescored_rel":
            abs(rescored - ref.latency) / ref.latency}))
    assert rel <= TIE_RTOL, rel
    assert abs(rescored - ref.latency) <= TIE_RTOL * ref.latency, rescored

    # The card's lattice solve under torch.profiler.
    hw_used = hw.replace(diagonal_links=True)
    solve_opts = EvalOptions(redistribution=True, async_exec=False)
    before = miqp_lattice.solve_lattice_batch.score_calls
    prof = scoring_breakdown(
        lambda: run_miqp(task, hw_used, "latency", solve_opts,
                         MIQPConfig()), before)
    log("optimize", "lattice solve on the card, profiled: "
        + json.dumps(prof))

    # The auto threshold: torch on the card against numpy, one
    # population of ViT genomes at each size, copies included; the two
    # agree at every size.
    ev_np = Evaluator(task, hw_used, solve_opts)
    ev_t = Evaluator(task, hw_used, solve_opts, backend="torch")
    rows = []
    for pop in CROSSOVER_POPULATIONS:
        Px, Py, coll = random_genomes(task, hw_used, pop, seed=pop)
        rd = np.repeat(ev_np.chain_valid[None], pop, 0).astype(np.float64)
        want = ev_np.evaluate_batch(Px, Py, coll, rd)
        got = ev_t.evaluate_batch(Px, Py, coll, rd)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=TIE_RTOL,
                                       atol=0, err_msg=key)
        np_ms = 1e3 * statistics.median(
            _host_time(lambda: ev_np.evaluate_batch(Px, Py, coll, rd))
            for _ in range(3))
        t_ms = 1e3 * statistics.median(
            _host_time(lambda: ev_t.evaluate_batch(Px, Py, coll, rd))
            for _ in range(5))
        rows.append({"P": pop, "numpy_ms": np_ms, "torch_cuda_ms": t_ms})
        log("optimize", "crossover " + json.dumps(rows[-1]))
    wins = [r["P"] for r in rows if r["torch_cuda_ms"] < r["numpy_ms"]]
    log("optimize", json.dumps({
        "AUTO_POPULATION_THRESHOLD": AUTO_POPULATION_THRESHOLD,
        "smallest_P_torch_cuda_wins": min(wins) if wins else None}))

    counts = launch_counts()
    assert not any(counts.values()), counts
    return counts


def _host_time(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


# Phase 7: the paper's batched solvers on the card, at the paper's sizes
# (the four workloads at batch 1, not cut). The GA's device engine is
# held to the JAX suite's invariants (tests/test_core_ga_engines.py) and,
# against the python engine on numpy, to solution quality within
# QUALITY_RTOL (median over 5 seeds: the two draw from different
# generators, DESIGN.md §10); an island solved alone must equal its
# batched record bit for bit (the sweep cache's invariant). The SGS
# kernel's schedules are bit-identical to every other engine's.
SWEEP_WORKLOADS = ("alexnet", "vit", "hydranet", "vision_mamba")
SWEEP_GRIDS = (4, 8, 16)
PIPE_BATCHES = (2, 4, 8, 16)
QUALITY_RTOL = 0.01
QUALITY_SEEDS = range(5)


def ga_invariants(task, hw, cfg, r):
    """tests/test_core_ga_engines.py's invariants of one GA record, on a
    real workload: exact per-op sums; each share on the unit lattice of
    the repaired uniform partition (multiples of R or C on the JAX
    suite's divisible tasks; a layer dim that is no multiple leaves its
    residue in one share, where every engine keeps it) and inside the
    Sec-6.2 window (or between it and that share's start); collectors
    in range; a best objective that never regresses."""
    from repro_torch.core.workload import (clamp_partition_to_domain,
                                           partition_domain,
                                           uniform_partition)
    part = r.partition
    part.validate(task)
    lo, hi = partition_domain(task, hw.X, hw.Y, hw.R, hw.C, cfg.slack)
    base = clamp_partition_to_domain(uniform_partition(task, hw.X, hw.Y),
                                     task, hw.X, hw.Y, hw.R, hw.C,
                                     cfg.slack)
    for got, start, unit, k in ((part.Px, base.Px, hw.R, 0),
                                (part.Py, base.Py, hw.C, 1)):
        assert ((got - start) % unit == 0).all()
        assert (got >= np.minimum(lo[:, k:k + 1] * unit, start)).all()
        assert (got <= np.maximum(hi[:, k:k + 1] * unit, start)).all()
    assert (part.collectors >= 0).all() and (part.collectors < hw.Y).all()
    assert (np.diff(r.history) <= 1e-18).all()
    assert math.isclose(r.objective, r.history[-1], rel_tol=1e-12)
    assert r.evaluations == len(r.history) * cfg.population


def same_ga(a, b):
    return (a.objective == b.objective
            and np.array_equal(a.history, b.history)
            and np.array_equal(a.partition.Px, b.partition.Px)
            and np.array_equal(a.partition.Py, b.partition.Py)
            and np.array_equal(a.partition.collectors, b.partition.collectors)
            and np.array_equal(a.redist_mask, b.redist_mask)
            and a.evaluations == b.evaluations)


def generation_steps(recs, cfg):
    """Generation steps one island group runs: whole chunks of
    min(patience, generations) until its longest island stops."""
    chunk = max(1, min(cfg.patience, cfg.generations))
    longest = max(len(r.history) for r in recs)
    return min(cfg.generations, -(-longest // chunk) * chunk)


def hetero_grids():
    """benchmarks/fig_hetero.py's class-count axis on a 4x4 type-A HBM
    package: homogeneous, 2-class (fast/slow half rows), 4-class."""
    import dataclasses

    from repro_torch.core.hw import ChipletClass, make_hw
    fast = ChipletClass("fast", freq_hz=1.5e9, bw_nop=120e9)
    base = ChipletClass("base")
    mid = ChipletClass("mid", freq_hz=0.75e9, bw_nop=45e9)
    slow = ChipletClass("slow", freq_hz=0.5e9, bw_nop=30e9, mem_scale=0.5)
    hw = make_hw("A", 4, "hbm")
    return {
        "homogeneous": hw,
        "two_class": dataclasses.replace(
            hw, chiplet_classes=(fast, slow),
            class_assignment=(0,) * 8 + (1,) * 8),
        "four_class": dataclasses.replace(
            hw, chiplet_classes=(fast, base, mid, slow),
            class_assignment=(0,) * 4 + (1,) * 4 + (2,) * 4 + (3,) * 4),
    }


def ga_profile(fn, generations, chunks):
    """One GA solve under torch.profiler: kernels per generation, the
    host's synchronising calls per chunk, the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = 0
    copies, waits = collections.Counter(), collections.Counter()
    busy_us = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy_us += e.self_device_time_total
            if e.name.startswith(("Memcpy", "Memset")):
                copies[e.name.split()[0] + " " + e.name.split()[1]] += 1
            else:
                kernels += 1
        elif e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaMemcpy", "cudaEventSynchronize"):
            waits[e.name] += 1
    return {"wall_s": wall_us / 1e6, "generation_steps": generations,
            "chunks": chunks, "kernels_per_generation": kernels / generations,
            "copies": dict(copies),
            "host_wait_calls (one cudaDeviceSynchronize is the profile's)":
                dict(waits),
            "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / wall_us}


def counted_syncs(fn):
    """Synchronising CUDA calls of ``fn`` as torch's sync debug mode
    reports them."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchronizing CUDA operation" in str(w.message)
               for w in caught)


def phase_sweeps():
    """Phase 7: the paper's batched solvers through repro_torch.core.sweep
    on the card: (a) Fig. 9/10's GA leg, (b) fig_hetero's island batch,
    (c) the GA's quality against the python engine, (d) MIQP through
    solve_grid, (e) Fig. 11's pipelining through pipeline_sweep and the
    SGS kernel. No TPU kernel lies on this path: their counts stay 0;
    the SGS kernel launches once per (n_ops, batch) group of (e)."""
    from repro_torch.core import evaluator_torch, ga_torch, miqp_lattice
    from repro_torch.core import sweep
    from repro_torch.core.evaluator import EvalOptions
    from repro_torch.core.ga import GAConfig, run_ga
    from repro_torch.core.hw import make_hw
    from repro_torch.core.miqp import MIQPConfig, run_miqp
    from repro_torch.core.pipelining import (_frontier_schedule_host,
                                             build_jobs, chain_priorities,
                                             list_schedule)
    from repro_torch.core.pipelining_torch import schedule_batch
    from repro_torch.graphs import WORKLOADS
    from repro_torch.kernels.sgs.kernel import sgs_batch, step_probe
    from repro_torch.kernels.sgs.ref import sgs_batch_ref

    t_phase = time.perf_counter()
    reset_launch_counts()
    sweep.clear_cache()
    calls = evaluator_torch.grid_evaluate.calls
    tasks = {w: WORKLOADS[w](batch=1) for w in SWEEP_WORKLOADS}
    ga_opts = EvalOptions(redistribution=True, async_exec=True)
    log("sweeps", "workloads " + json.dumps(
        {w: len(t) for w, t in tasks.items()}) + " GEMMs")

    # (a) Fig. 9/10's GA leg: every workload on 4x4, 8x8 and 16x16 type-A
    # HBM with diagonal links, both objectives, one island per shape group.
    cfg = GAConfig(generations=60, population=64)
    grid_pts = sweep.grid(g=SWEEP_GRIDS, w=SWEEP_WORKLOADS)
    hws = {g: make_hw("A", g, "hbm") for g in SWEEP_GRIDS}
    base = sweep.eval_sweep([sweep.EvalPoint(tasks[p["w"]], hws[p["g"]])
                             for p in grid_pts])
    pts = [sweep.EvalPoint(tasks[p["w"]],
                           hws[p["g"]].replace(diagonal_links=True), ga_opts)
           for p in grid_pts]
    for objective in ("latency", "edp"):
        calls.clear()
        t0 = time.perf_counter()
        recs = sweep.solve_grid(pts, objective, cfg, backend="torch")
        solve_s = time.perf_counter() - t0
        steps = sum(generation_steps([r], cfg) for r in recs)
        assert dict(calls) == {"cuda": steps}, (dict(calls), steps)
        for pt, r in zip(pts, recs):
            ga_invariants(pt.task, pt.hw, cfg, r)
        scored = sweep.eval_sweep(
            [sweep.EvalPoint(pt.task, pt.hw, ga_opts, partition=r.partition,
                             redist_mask=r.redist_mask)
             for pt, r in zip(pts, recs)])
        speedups = {}
        for p, r, ls, sc in zip(grid_pts, recs, base, scored):
            assert math.isclose(sc[objective], r.objective, rel_tol=1e-9)
            speedups[f"{p['g']}x{p['g']}/{p['w']}"] = ls[objective] / \
                sc[objective]
        log("sweeps", json.dumps({
            "leg": "fig9_10_ga", "objective": objective,
            "points": len(pts), "solve_grid_s": solve_s,
            "fitness_calls": dict(calls),
            "generations": [len(r.history) for r in recs],
            "speedup_vs_ls": speedups}))

    # (b) fig_hetero's GA leg: AlexNet and ViT x homogeneous, 2-class and
    # 4-class 4x4 grids, EDP: 2 groups of 3 islands. One island of each
    # group solved alone must equal its batched record bit for bit.
    cfg_h = GAConfig(population=64, generations=60, seed=0)
    grids = hetero_grids()
    het = [sweep.EvalPoint(tasks[w], hw, ga_opts)
           for w in ("alexnet", "vit") for hw in grids.values()]
    calls.clear()
    t0 = time.perf_counter()
    recs = sweep.solve_grid(het, "edp", cfg_h, backend="torch", cache=False)
    torch_s = time.perf_counter() - t0
    for pt, r in zip(het, recs):
        ga_invariants(pt.task, pt.hw, cfg_h, r)
    steps = sum(generation_steps(recs[i:i + 3], cfg_h) for i in (0, 3))
    assert dict(calls) == {"cuda": steps}, (dict(calls), steps)
    solo_equal = {}
    for i in (1, 5):      # alexnet two_class, vit four_class
        solo = sweep.solve_grid([het[i]], "edp", cfg_h, backend="torch",
                                cache=False)[0]
        solo_equal[het[i].task.name + "/" + list(grids)[i % 3]] = \
            same_ga(solo, recs[i])
    assert all(solo_equal.values()), solo_equal
    t0 = time.perf_counter()
    ref = sweep.solve_grid(het, "edp", cfg_h, backend="numpy", cache=False)
    numpy_s = time.perf_counter() - t0
    log("sweeps", json.dumps({
        "leg": "fig_hetero_ga", "islands_per_call": [3, 3],
        "solve_grid_s_torch_cuda": torch_s,
        "solve_grid_s_numpy_vectorized": numpy_s,
        "edp_torch_cuda": [r.objective for r in recs],
        "edp_numpy_vectorized": [r.objective for r in ref],
        "generations": [len(r.history) for r in recs],
        "solo_equals_batched": solo_equal}))
    vit_pt = het[3]
    one = lambda: ga_torch.run_ga_torch(  # noqa: E731
        vit_pt.task, vit_pt.hw, "edp", ga_opts, cfg_h)
    r = one()
    steps = generation_steps([r], cfg_h)
    chunks = -(-steps // max(1, min(cfg_h.patience, cfg_h.generations)))
    syncs = counted_syncs(one)
    prof = ga_profile(one, steps, chunks)
    prof.update({"sync_debug_mode_syncs": syncs,
                 "generations_evaluated": len(r.history)})
    log("sweeps", "one ViT island solve on the card, profiled: "
        + json.dumps(prof))
    assert syncs == chunks, (syncs, chunks)

    # (c) Quality on the card: the JAX suite's test at its sizes.
    hw_q = make_hw("A", 4, "hbm", diagonal_links=True)
    kw = dict(generations=30, population=32, patience=30)
    quality = {}
    for w in ("alexnet", "vit"):
        t0 = time.perf_counter()
        card = [run_ga(tasks[w], hw_q, "latency", ga_opts,
                       GAConfig(seed=s, engine="vectorized",
                                backend="torch", **kw)).objective
                for s in QUALITY_SEEDS]
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        py = [run_ga(tasks[w], hw_q, "latency", ga_opts,
                     GAConfig(seed=s, **kw)).objective
              for s in QUALITY_SEEDS]
        py_s = time.perf_counter() - t0
        rel = statistics.median(card) / statistics.median(py) - 1.0
        quality[w] = {"median_torch_cuda": statistics.median(card),
                      "median_python_numpy": statistics.median(py),
                      "rel": rel, "torch_cuda_s": card_s,
                      "python_numpy_s": py_s}
        assert abs(rel) <= QUALITY_RTOL, (w, quality[w])
    log("sweeps", "quality " + json.dumps(quality))

    # (d) MIQP through solve_grid: the four workloads on 4x4 type A,
    # latency; each record equals a solo run_miqp of its point.
    mopts = EvalOptions(redistribution=True, async_exec=False)
    hw_m = make_hw("A", 4, "hbm", diagonal_links=True)
    mpts = [sweep.EvalPoint(tasks[w], hw_m, mopts) for w in SWEEP_WORKLOADS]
    calls.clear()
    miqp_lattice.solve_lattice_batch.score_calls = 0
    t0 = time.perf_counter()
    mrecs = sweep.solve_grid(mpts, "latency", MIQPConfig(), backend="torch",
                             method="miqp")
    miqp_s = time.perf_counter() - t0
    scored = miqp_lattice.solve_lattice_batch.score_calls
    assert scored > 0 and dict(calls) == {"cuda": scored}, (scored, calls)
    for pt, rec in zip(mpts, mrecs):
        solo = run_miqp(pt.task, pt.hw, "latency", mopts, MIQPConfig())
        assert solo.objective == rec.objective, pt.task.name
        for f in ("Px", "Py", "collectors"):
            assert np.array_equal(getattr(solo.partition, f),
                                  getattr(rec.partition, f)), pt.task.name
    log("sweeps", json.dumps({
        "leg": "miqp_solve_grid", "solve_grid_s": miqp_s,
        "scoring_calls": scored,
        "latency_us": {pt.task.name: r.objective * 1e6
                       for pt, r in zip(mpts, mrecs)},
        "status": [r.milp_status for r in mrecs]}))

    # (e) Fig. 11's pipelining: the LS-baseline segments of the four
    # workloads on 4x4 HBM types A-D at batches 2-16, 16 groups of 4.
    types = ("A", "B", "C", "D")
    ls = sweep.eval_sweep([sweep.EvalPoint(tasks[w], make_hw(t, 4, "hbm"))
                           for w in SWEEP_WORKLOADS for t in types])
    segs = [[(f"op{i}", float(a), float(b), float(c))
             for i, (a, b, c) in enumerate(zip(r["t_in"], r["t_comp"],
                                               r["t_out"]))]
            for r in ls]
    ppts = [sweep.PipelinePoint(sg, b) for sg in segs for b in PIPE_BATCHES]
    counts = launch_counts()
    assert not any(counts[k] for k in TPU_KERNELS), counts
    reset_launch_counts()
    t0 = time.perf_counter()
    precs = sweep.pipeline_sweep(ppts, backend="torch")
    pipe_s = time.perf_counter() - t0
    counts = launch_counts()
    n_groups = len(SWEEP_WORKLOADS) * len(PIPE_BATCHES)
    assert counts["sgs_batch"] == n_groups, (counts, n_groups)
    assert not any(counts[k] for k in TPU_KERNELS), counts
    log("sweeps", json.dumps({
        "leg": "pipeline_sweep", "points": len(ppts), "groups": n_groups,
        "sgs_launches": counts["sgs_batch"], "pipeline_sweep_s": pipe_s,
        "speedup": {f"{w}/{t}/b{b}": precs[(i * 4 + j) * 4 + k].speedup
                    for i, w in enumerate(SWEEP_WORKLOADS)
                    for j, t in enumerate(types)
                    for k, b in enumerate(PIPE_BATCHES)}}))
    # Every group again, kernel against the plain version on the card
    # and the host frontier per point; one group against list_schedule.
    for i, w in enumerate(SWEEP_WORKLOADS):
        grp = slice(i * len(types), (i + 1) * len(types))
        durs = np.stack([np.maximum(np.array([s[1:] for s in sg]), 0.0)
                         for sg in segs[grp]])
        for b in PIPE_BATCHES:
            out = schedule_batch(durs, b)
            dur = torch.from_numpy(durs.reshape(len(types), -1)).cuda()
            prio = torch.from_numpy(np.stack(
                [chain_priorities(d) for d in durs.reshape(len(types), -1)]
            )).cuda()
            ms_ref, st_ref = sgs_batch_ref(dur, prio, b)
            assert np.array_equal(out["makespan"], ms_ref.cpu().numpy())
            assert np.array_equal(out["starts"], st_ref.cpu().numpy())
            for g in range(len(types)):
                d = durs[g].reshape(-1)
                ms_h, st_h = _frontier_schedule_host(d, chain_priorities(d),
                                                     b)
                assert out["makespan"][g] == ms_h, (w, b, g)
                assert np.array_equal(out["starts"][g], st_h), (w, b, g)
                pr = precs[(i * len(types) + g) * len(PIPE_BATCHES)
                           + PIPE_BATCHES.index(b)]
                assert pr.pipelined == ms_h and pr.batch == b
    serial_w, serial_b = "vit", 16
    i = SWEEP_WORKLOADS.index(serial_w)
    for g in range(len(types)):
        sg = segs[i * len(types) + g]
        ms_s, starts = list_schedule(build_jobs(sg, serial_b))
        L = 3 * len(sg)
        st_s = np.array([[starts[s * L + p] for p in range(L)]
                         for s in range(serial_b)])
        out = schedule_batch(np.array([s[1:] for s in sg])[None], serial_b)
        assert out["makespan"][0] == ms_s
        assert np.array_equal(out["starts"][0], st_s)
    log("sweeps", f"SGS schedules bit-identical: kernel vs plain on the "
        f"card and vs the host frontier at all {n_groups} groups, vs "
        f"list_schedule at {serial_w} batch {serial_b} ({len(types)} points)")

    # The largest group (ViT, batch 16) timed: the kernel (one call and
    # 20 back to back), the plain version on the card, the host frontier;
    # the bound is the dependent steps at the measured latency of one
    # empty warp-reduction step.
    sg_vit = segs[i * len(types):(i + 1) * len(types)]
    durs = np.stack([np.maximum(np.array([s[1:] for s in sg]), 0.0)
                     .reshape(-1) for sg in sg_vit])
    dur = torch.from_numpy(durs).cuda()
    prio = torch.from_numpy(np.stack([chain_priorities(d) for d in durs])
                            ).cuda()
    G, L = dur.shape
    B = serial_b
    ms_k, st_k = sgs_batch(dur, prio, B)
    ms_p, st_p = sgs_batch_ref(dur, prio, B)
    max_abs_err = max(float((ms_k - ms_p).abs().max()),
                      float((st_k - st_p).abs().max()))
    assert max_abs_err == 0.0, max_abs_err
    kernel_ms = time_ms(lambda: sgs_batch(dur, prio, B))
    kernel_burst = burst_ms(lambda: sgs_batch(dur, prio, B))
    plain_ms = time_ms(lambda: sgs_batch_ref(dur, prio, B), reps=3,
                       warmup=1)
    host_ms = 1e3 * statistics.median(
        _host_time(lambda: [_frontier_schedule_host(d, chain_priorities(d),
                                                    B) for d in durs])
        for _ in range(3))
    steps = B * L
    probe_ms = burst_ms(lambda: step_probe(steps, dur.device))
    nbytes = 8 * (2 * G * L + G + G * B * L)
    bytes_ms = 1e3 * nbytes / H100_BYTES_PER_S
    row = {"shape": {"G": G, "batch": B, "L": L, "steps": steps},
           "kernel_ms": kernel_ms, "kernel_burst_ms": kernel_burst,
           "plain_ms": plain_ms, "host_numpy_frontier_ms": host_ms,
           "warp_step_us": 1e3 * probe_ms / steps,
           "bound_ms": max(probe_ms, bytes_ms), "bytes_bound_ms": bytes_ms,
           "bound_by": "operations",
           "bound_note": "dependent SGS steps x the measured latency of "
                         "one empty warp-reduction step",
           "max_abs_err": max_abs_err, "library_ms": None}
    log("sweeps", "sgs_batch vit batch 16 " + json.dumps(row))
    assert not any(launch_counts()[k] for k in TPU_KERNELS)
    log("sweeps", f"phase 7 in {time.perf_counter() - t_phase:.1f}s")
    return {"sgs_batch": counts["sgs_batch"],
            **{k: counts[k] for k in TPU_KERNELS}}, row


# Phase 8: flow congestion on the card. The batched netsim (one kernel
# launch for the Fig. 3 grid) and the evaluator's congestion="flow" mode
# (one launch an evaluator call) are held to the numpy engines at
# FLOW_RTOL, the JAX backends' contract (DESIGN.md §8); latency and done
# times are expected bit-identical (every float64 operation is numpy's,
# in its order), link_bytes sum in another order. The GA under flow runs
# at the paper's largest mesh on the full ViT-B/16.
FLOW_RTOL = 1e-9
FLOW_ATOL_BYTES = 1e-3
FIG11_WORKLOADS = ("alexnet", "vit", "hydranet")
FLOW_GA_GRID = 16         # the paper's largest mesh
FLOW_GA_GENERATIONS = 24
FLOW_GA_PATIENCE = 12
FLOW_SAMPLE = 32           # simulations the plain version and numpy rerun


def _simulate_numpy(caps, inc, msgs):
    """The port's numpy ``simulate_flows`` per simulation: ``caps [L]``,
    ``inc [F, L]``, ``msgs [S, F]`` → latencies [S], done [S, F]."""
    from repro_torch.core.netsim import simulate_flows
    outs = [simulate_flows(inc, caps, m) for m in msgs]
    return (np.array([o["latency"] for o in outs]),
            np.stack([o["done"] for o in outs]))


def phase_flow():
    """Phase 8: flow congestion through repro_torch.core on the card:
    (a) Fig. 3's grid through netsim_sweep, one kernel launch; (b) Fig.
    8's LS flow column through eval_sweep; (c) Fig. 11's flow segments of
    MIQP schedules through pipeline_sweep; (d) a GA under flow on ViT-B/16
    at 16x16, its kernel timed at that shape beside its bound, plain
    version and numpy, and the JAX suite's toy solve_grid under flow.
    Every launch count is set to 0 before a leg and read after it; no TPU
    kernel launches."""
    import dataclasses

    from repro_torch.core import api, evaluator_torch, sweep
    from repro_torch.core.evaluator import EvalOptions, Evaluator
    from repro_torch.core.ga import GAConfig, run_ga
    from repro_torch.core.hw import make_hw
    from repro_torch.core.netsim import fig3_net, simulate_flows
    from repro_torch.core.pipelining import chain_priorities
    from repro_torch.core.pipelining_torch import schedule_batch
    from repro_torch.core.workload import GemmOp, Task
    from repro_torch.graphs import WORKLOADS
    from repro_torch.kernels.netsim import ops as netsim_ops
    from repro_torch.kernels.netsim.kernel import (blocks_per_sm,
                                                   step_probe, waterfill)
    from repro_torch.kernels.netsim.ref import waterfill_ref
    from repro_torch.kernels.sgs.ref import sgs_batch_ref

    t_phase = time.perf_counter()
    sweep.clear_cache()
    main_launches = collections.Counter()

    def leg_counts(name):
        counts = launch_counts()
        assert not any(counts[k] for k in TPU_KERNELS), (name, counts)
        main_launches.update(counts)
        return counts

    # (a) Fig. 3: memory x placement x NoP bandwidth on a 4x4 mesh, 1 GB
    # pulls, one launch for the whole grid.
    GB = 1e9
    cells = sweep.grid(memory=("dram", "hbm"),
                       placement=("peripheral", "central"),
                       bw_nop=(60 * GB, 120 * GB))
    nets = [fig3_net(c["memory"], c["placement"], c["bw_nop"])
            for c in cells]
    reset_launch_counts()
    t0 = time.perf_counter()
    recs = sweep.netsim_sweep(nets, GB, backend="torch")
    fig3_s = time.perf_counter() - t0
    counts = leg_counts("fig3")
    assert counts["netsim_waterfill"] == 1, counts
    bitwise = True
    lat = {}
    for c, net, rec in zip(cells, nets, recs):
        ref = simulate_flows(net.pull_incidence(), net.link_caps(),
                             np.full(16, GB))
        np.testing.assert_allclose(rec["latency"], ref["latency"],
                                   rtol=FLOW_RTOL)
        np.testing.assert_allclose(rec["done"], ref["done"], rtol=FLOW_RTOL)
        np.testing.assert_allclose(rec["link_bytes"], ref["link_bytes"],
                                   rtol=FLOW_RTOL, atol=FLOW_ATOL_BYTES)
        bitwise &= (rec["latency"] == ref["latency"]
                    and np.array_equal(rec["done"], ref["done"]))
        lat[(c["memory"], c["placement"], c["bw_nop"] / GB)] = \
            rec["latency"]
    ratios = {
        "hbm_nop_scaling": lat[("hbm", "peripheral", 60)]
        / lat[("hbm", "peripheral", 120)],
        "dram_nop_scaling": lat[("dram", "peripheral", 60)]
        / lat[("dram", "peripheral", 120)],
        "central_vs_peripheral": lat[("hbm", "peripheral", 60)]
        / lat[("hbm", "central", 60)]}
    assert abs(ratios["hbm_nop_scaling"] - 2.0) <= 2e-3, ratios
    assert abs(ratios["dram_nop_scaling"] - 1.0) <= 1e-6, ratios
    assert abs(ratios["central_vs_peripheral"] - 1.5) <= 0.1, ratios
    assert math.isclose(lat[("dram", "peripheral", 60)], 16 / 60,
                        rel_tol=1e-6), lat      # 16 GB over 60 GB/s
    log("flow", json.dumps({
        "leg": "fig3_netsim_sweep", "cells": len(nets),
        "launches": counts["netsim_waterfill"],
        "netsim_sweep_s (host clock)": fig3_s,
        "latency_ms": {f"{m}/{p}/nop{int(b)}": v * 1e3
                       for (m, p, b), v in lat.items()},
        "ratios (paper: 2.00, 1.00, 1.53)": ratios,
        "latency_and_done_bit_identical_to_numpy": bitwise}))

    # (b) Fig. 8's LS column under both congestion models: the four
    # workloads on 4x4 HBM types A-D; the flow records held to numpy.
    tasks = {w: WORKLOADS[w](batch=1) for w in SWEEP_WORKLOADS}
    hws = {t: make_hw(t, 4, "hbm") for t in "ABCD"}
    pts = [sweep.EvalPoint(tasks[w], hws[t], EvalOptions(congestion=c))
           for t in hws for w in tasks for c in ("regime", "flow")]
    reset_launch_counts()
    t0 = time.perf_counter()
    recs = sweep.eval_sweep(pts, backend="torch")
    fig8_s = time.perf_counter() - t0
    counts = leg_counts("fig8")
    flow_pts = [p for p in pts if p.options.congestion == "flow"]
    t0 = time.perf_counter()
    ref = sweep.eval_sweep(flow_pts, backend="numpy")
    fig8_numpy_s = time.perf_counter() - t0
    flow_recs = recs[1::2]
    for pt, got, want in zip(flow_pts, flow_recs, ref):
        for k in ("latency", "energy", "edp", "t_in", "t_comp", "t_out"):
            np.testing.assert_allclose(got[k], want[k], rtol=FLOW_RTOL,
                                       err_msg=f"{pt.task.name} {k}")
    flow_vs_regime = {f"{t}/{w}": recs[2 * i + 1]["latency"]
                      / recs[2 * i]["latency"]
                      for i, (t, w) in enumerate(
                          (t, w) for t in hws for w in tasks)}
    # Type C: no byte crosses the mesh, so flow == regime.
    assert all(abs(v - 1.0) <= 1e-12 for k, v in flow_vs_regime.items()
               if k.startswith("C/")), flow_vs_regime
    log("flow", json.dumps({
        "leg": "fig8_ls_flow_column", "points": len(pts),
        "launches": counts["netsim_waterfill"],
        "eval_sweep_s_torch_cuda (host clock)": fig8_s,
        "eval_sweep_s_numpy_flow_only (host clock)": fig8_numpy_s,
        "flow_vs_regime": flow_vs_regime}))

    # (c) Fig. 11's flow variant: MIQP schedules on 4x4 type-A HBM,
    # re-scored under flow on the card (held to numpy), pipelined at
    # batches 2-16 through pipeline_sweep and the SGS kernel.
    hw11 = make_hw("A", 4, "hbm")
    t0 = time.perf_counter()
    scheds = {w: api.optimize(tasks[w], hw11, "miqp")
              for w in FIG11_WORKLOADS}
    miqp_s = time.perf_counter() - t0
    reset_launch_counts()
    # Scored with numpy (optimize's default), re-scored under flow by the
    # torch evaluator on the card.
    segs = {w: dataclasses.replace(scheds[w], backend="torch")
            .segments("flow") for w in FIG11_WORKLOADS}
    ppts = [sweep.PipelinePoint(segs[w], b) for w in FIG11_WORKLOADS
            for b in PIPE_BATCHES]
    t0 = time.perf_counter()
    precs = sweep.pipeline_sweep(ppts, backend="torch")
    pipe_s = time.perf_counter() - t0
    counts = leg_counts("fig11")
    assert counts["netsim_waterfill"] == len(FIG11_WORKLOADS), counts
    n_pgroups = len(FIG11_WORKLOADS) * len(PIPE_BATCHES)
    assert counts["sgs_batch"] == n_pgroups, counts
    for w in FIG11_WORKLOADS:
        want = np.array([s[1:] for s in scheds[w].segments("flow")])
        got = np.array([s[1:] for s in segs[w]])
        np.testing.assert_allclose(got, want, rtol=FLOW_RTOL, err_msg=w)
    for i, w in enumerate(FIG11_WORKLOADS):
        durs = np.maximum(np.array([s[1:] for s in segs[w]]), 0.0)
        d = durs.reshape(-1)
        dur = torch.from_numpy(d[None]).cuda()
        prio = torch.from_numpy(chain_priorities(d)[None]).cuda()
        for j, b in enumerate(PIPE_BATCHES):
            out = schedule_batch(durs[None], b)
            ms_ref, st_ref = sgs_batch_ref(dur, prio, b)
            assert np.array_equal(out["makespan"], ms_ref.cpu().numpy())
            assert np.array_equal(out["starts"], st_ref.cpu().numpy())
            assert precs[i * len(PIPE_BATCHES) + j].pipelined == \
                out["makespan"][0]
    log("flow", json.dumps({
        "leg": "fig11_flow_pipelining", "miqp_s (host clock)": miqp_s,
        "netsim_launches": counts["netsim_waterfill"],
        "sgs_launches": counts["sgs_batch"],
        "pipeline_sweep_s (host clock)": pipe_s,
        "speedup": {f"{w}/b{b}": precs[i * len(PIPE_BATCHES) + j].speedup
                    for i, w in enumerate(FIG11_WORKLOADS)
                    for j, b in enumerate(PIPE_BATCHES)},
        "schedules": "bit-identical to the plain SGS"}))

    # (d) A GA under flow at 16x16 on the full ViT-B/16: every fitness
    # call on the card, one waterfilling launch a generation.
    task = tasks["vit"]
    hw16 = make_hw("A", FLOW_GA_GRID, "hbm")
    gopts = EvalOptions(congestion="flow", redistribution=True,
                        async_exec=True)
    gcfg = GAConfig(population=64, engine="vectorized", backend="torch",
                    generations=FLOW_GA_GENERATIONS,
                    patience=FLOW_GA_PATIENCE, seed=0)
    calls = evaluator_torch.grid_evaluate.calls
    calls.clear()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = run_ga(task, hw16, "latency", gopts, gcfg)
    torch.cuda.synchronize()
    ga_s = time.perf_counter() - t0
    counts = leg_counts("ga_flow")
    steps = generation_steps([res], gcfg)
    chunks = -(-steps // max(1, min(gcfg.patience, gcfg.generations)))
    assert dict(calls) == {"cuda": steps}, (dict(calls), steps)
    assert counts["netsim_waterfill"] == steps, (counts, steps)
    ga_invariants(task, hw16, gcfg, res)
    score = Evaluator(task, hw16, gopts).evaluate(res.partition,
                                                  res.redist_mask).latency
    assert math.isclose(score, res.objective, rel_tol=FLOW_RTOL)
    one = lambda: run_ga(task, hw16, "latency", gopts, gcfg)  # noqa: E731
    syncs = counted_syncs(one)
    assert syncs == chunks, (syncs, chunks)
    prof = ga_profile(one, steps, chunks)
    prof.update({"sync_debug_mode_syncs": syncs,
                 "netsim_launches_per_generation":
                     counts["netsim_waterfill"] / steps,
                 "s_per_generation (host clock)": ga_s / steps,
                 "ga_s (host clock, first run)": ga_s,
                 "best_latency_us": res.objective * 1e6})
    log("flow", f"GA under flow, ViT-B/16 on {FLOW_GA_GRID}x{FLOW_GA_GRID} "
        f"type A, P 64, profiled: " + json.dumps(prof))

    # The kernel at the GA's shape: the first generation's fitness call
    # recorded as the main path makes it.
    seen = []
    real = netsim_ops.waterfill

    def record(caps, inc, msgs, routes=None, link_bytes=True):
        seen.append((caps, msgs, routes))
        return real(caps, inc, msgs, routes=routes, link_bytes=link_bytes)

    netsim_ops.waterfill = record
    try:
        run_ga(task, hw16, "latency", gopts,
               dataclasses.replace(gcfg, generations=1))
    finally:
        netsim_ops.waterfill = real
    caps, msgs, routes = seen[0]
    N, S, F = msgs.shape
    L, R = caps.shape[1], routes.shape[2]
    lat_k, done_k, _, rounds = waterfill(caps, routes, msgs,
                                         link_bytes=False)
    torch.cuda.synchronize()
    kernel_ms = time_ms(lambda: waterfill(caps, routes, msgs,
                                          link_bytes=False), reps=10)
    kernel_burst = burst_ms(lambda: waterfill(caps, routes, msgs,
                                              link_bytes=False),
                            calls=10, reps=3)
    _, dinc, cinc = hw16.topology.flow_net()
    inc = torch.from_numpy(np.stack([dinc, cinc])).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat_p, done_p, _, rounds_p = waterfill_ref(caps, inc, msgs,
                                               link_bytes=False)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    assert torch.equal(rounds, rounds_p)
    full_bitwise = torch.equal(lat_k, lat_p) and torch.equal(done_k, done_p)
    torch.testing.assert_close(lat_k, lat_p, rtol=FLOW_RTOL, atol=0)
    torch.testing.assert_close(done_k, done_p, rtol=FLOW_RTOL, atol=0)
    max_abs_err = max(float((lat_k - lat_p).abs().max()),
                      float((done_k - done_p).abs().max()))
    # A random sample of the launch's simulations, half of each network:
    # the plain version alone on the sample and numpy, per simulation.
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(np.stack([rng.choice(S, FLOW_SAMPLE // 2,
                                                replace=False)
                                     for _ in range(N)])).cuda()
    sample = torch.gather(msgs, 1, idx[..., None].expand(-1, -1, F))
    lat_s, done_s, _, _ = waterfill_ref(caps, inc, sample,
                                        link_bytes=False)
    torch.cuda.synchronize()
    sample_plain_ms = time_ms(lambda: waterfill_ref(
        caps, inc, sample, link_bytes=False), reps=3, warmup=1)
    flows = (dinc, cinc)
    t0 = time.perf_counter()
    numpy_out = [_simulate_numpy(caps[n].cpu().numpy(), flows[n],
                                 sample[n].cpu().numpy()) for n in range(N)]
    numpy_ms = 1e3 * (time.perf_counter() - t0)
    gi = idx.cpu().numpy()
    lk, dk = lat_k.cpu().numpy(), done_k.cpu().numpy()
    sample_bitwise = True
    for n in range(N):
        for got_l, got_d, want_l, want_d in (
                (lk[n, gi[n]], dk[n, gi[n]], *numpy_out[n]),
                (lk[n, gi[n]], dk[n, gi[n]], lat_s[n].cpu().numpy(),
                 done_s[n].cpu().numpy())):
            np.testing.assert_allclose(got_l, want_l, rtol=FLOW_RTOL)
            np.testing.assert_allclose(got_d, want_d, rtol=FLOW_RTOL)
            sample_bitwise &= (np.array_equal(got_l, want_l)
                               and np.array_equal(got_d, want_d))
    # The bound: the bytes each way at HBM rate, or the dependent rounds
    # at the measured latency of one empty block-argmin round, spread
    # over the blocks the card holds at once.
    probe_rounds = 20000
    probe_ms = burst_ms(lambda: step_probe(probe_rounds, F, caps.device),
                        calls=5, reps=3)
    round_us = 1e3 * probe_ms / probe_rounds
    resident = (torch.cuda.get_device_properties(0).multi_processor_count
                * blocks_per_sm(F, L, R))
    r = rounds.cpu().numpy().astype(np.int64)
    rounds_ms = max(int(r.max()) * round_us,
                    int(r.sum()) * round_us / resident) / 1e3
    nbytes = (8 * N * L + 4 * N * F * R + 8 * N * S * F        # in
              + 8 * N * S + 8 * N * S * F + 4 * N * S)         # out
    bytes_ms = 1e3 * nbytes / H100_BYTES_PER_S
    row = {"shape": {"networks": N, "simulations_each": S, "F": F, "L": L,
                     "R": R, "threads": max(32, -(-F // 32) * 32),
                     "resident_blocks": resident},
           "kernel_ms": kernel_ms, "kernel_burst_ms": kernel_burst,
           "plain_ms": plain_ms,
           "plain_ms_per_sim_sample": sample_plain_ms / FLOW_SAMPLE,
           "numpy_ms_per_sim_sample": numpy_ms / FLOW_SAMPLE,
           "rounds_max": int(r.max()), "rounds_mean": float(r.mean()),
           "rounds_sum": int(r.sum()), "round_us": round_us,
           "bound_ms": max(rounds_ms, bytes_ms), "rounds_bound_ms":
               rounds_ms, "bytes_bound_ms": bytes_ms,
           "bound_by": "operations" if rounds_ms >= bytes_ms else "bytes",
           "bound_note": "dependent waterfilling rounds x the measured "
                         "latency of one empty block-argmin round, the "
                         "longest simulation's or the sum over the "
                         "resident blocks, whichever is larger",
           "max_abs_err": max_abs_err,
           "bit_identical_to_plain_full_launch": full_bitwise,
           "bit_identical_on_sample (plain and numpy)": sample_bitwise,
           "library_ms": None}
    log("flow", "netsim_waterfill at the GA's shape " + json.dumps(row))

    # The JAX suite's GA-under-flow case on the card (toy task, 2x2): the
    # second solve_grid call hits the cache with the same objective.
    ops = [GemmOp("g0", M=512, K=256, N=512),
           GemmOp("g1", M=512, K=512, N=512, chained=True, sync=True)]
    toy = Task("flowtoy2", ops)
    tpts = [sweep.EvalPoint(toy, make_hw("A", 2, "hbm"), gopts)]
    tcfg = GAConfig(generations=2, population=8, patience=2, seed=0)
    before = sweep.cache_stats()
    first = sweep.solve_grid(tpts, "latency", tcfg, backend="torch")
    again = sweep.solve_grid(tpts, "latency", tcfg, backend="torch")
    after = sweep.cache_stats()
    assert after["hits"] == before["hits"] + 1, (before, after)
    assert again[0].objective == first[0].objective
    assert math.isfinite(first[0].objective) and first[0].objective > 0
    log("flow", json.dumps({"leg": "toy_solve_grid_flow",
                            "objective_us": first[0].objective * 1e6,
                            "second_call": "cache hit, same objective"}))
    assert not any(launch_counts()[k] for k in TPU_KERNELS)
    log("flow", f"phase 8 in {time.perf_counter() - t_phase:.1f}s")
    return dict(main_launches), row


# Phase 9: multi-tenant packages, the optimisation server and device
# sharding on the card. A multi-tenant solve's contention simulations
# (the joint and solo demands of every band assignment) run as ONE launch
# of the waterfilling kernel, whose slowdowns must equal the numpy
# engine's per-assignment loop bit for bit (every float64 operation is
# numpy's, in its order); scores are held to numpy at MT_RTOL, the torch
# backend's contract (DESIGN.md §8). The server's records must equal
# solo sweep calls bit for bit, and a sharded sweep the single-device
# one (DESIGN.md §14-§15).
MT_RTOL = 1e-9
MT_GRID = 16                  # the paper's largest mesh
SERVE_DEMO_REQUESTS = 64      # the JAX CLI demo's traffic
SERVE_WAIT_S = 300
SHARD_MESHES = (1, 3)         # the card listed once and three times
SHARD_GA = dict(population=64, generations=20, patience=8, seed=0)


def _same_record(a, b):
    """Bit-identical records of any family the server returns."""
    if isinstance(a, dict):
        return all(np.array_equal(a[k], b[k]) for k in
                   ("latency", "energy", "edp", "t_in", "t_comp", "t_out"))
    if hasattr(a, "pipelined"):
        return (a.batch, a.sequential, a.pipelined) == \
            (b.batch, b.sequential, b.pipelined)
    if hasattr(a, "assignment"):
        return (a.assignment == b.assignment and a.objective == b.objective
                and a.per_tenant == b.per_tenant
                and a.baseline == b.baseline
                and all(np.array_equal(p.Px, q.Px)
                        and np.array_equal(p.Py, q.Py)
                        for p, q in zip(a.partitions, b.partitions)))
    return (a.objective == b.objective
            and np.array_equal(a.partition.Px, b.partition.Px)
            and np.array_equal(a.partition.Py, b.partition.Py)
            and np.array_equal(a.redist_mask, b.redist_mask)
            and np.array_equal(getattr(a, "history", 0),
                               getattr(b, "history", 0)))


def _solo(req):
    """One request through its sweep call alone, uncached, on the card."""
    from repro_torch.core import sweep
    if req.kind == "eval":
        return sweep.eval_sweep([req.point], backend=req.backend,
                                cache=False)[0]
    if req.kind == "pipeline":
        return sweep.pipeline_sweep([req.point], req.cfg,
                                    backend=req.backend, cache=False)[0]
    return sweep.solve_grid([req.point], req.objective, req.cfg,
                            backend=req.backend, cache=False,
                            method=req.method)[0]


def phase_multitenant():
    """Phase 9: multi-tenant packages, the server and sharding through
    repro_torch on the card: (a) fig_hetero's multi-tenant leg at its
    full profile (AlexNet + ViT-B/16 on the two-class 4x4 grid), uniform
    held to numpy and GA beating the even split; (b) the paper's four
    workloads as four tenants on 16x16 type A, 64 band assignments, the
    contention in one launch bitwise numpy's, the kernel at that shape
    timed beside its bound and plain version; (c) the optimisation
    server on the CLI demo's traffic plus fig_hetero's GA points and (b)
    as requests: served == solo, its stats, a kill and restart from a
    store in build/ that recomputes nothing, one malformed request
    failing alone; (d) devices="sharded" with the card listed 1 and 3
    times on eval, GA islands, the netsim, the SGS and the lattice,
    bitwise the single-device records. No TPU kernel launches."""
    import os

    from repro_torch.core import evaluator_torch, sweep, sweep_shard
    from repro_torch.core import multitenant as mt
    from repro_torch.core.evaluator import EvalOptions
    from repro_torch.core.ga import GAConfig
    from repro_torch.core.hw import make_hw
    from repro_torch.core.miqp import MIQPConfig
    from repro_torch.core.netsim import fig3_net
    from repro_torch.core.workload import uniform_partition
    from repro_torch.graphs import WORKLOADS
    from repro_torch.kernels.netsim import ops as netsim_ops
    from repro_torch.kernels.netsim.kernel import (blocks_per_sm,
                                                   step_probe, waterfill)
    from repro_torch.kernels.netsim.ref import waterfill_ref
    from repro_torch.serve import BadRequest, OptRequest, OptServer
    from repro_torch.serve import optserver

    t_phase = time.perf_counter()
    sweep.clear_cache()
    main_launches = collections.Counter()
    calls = evaluator_torch.grid_evaluate.calls

    def leg_counts(name):
        counts = launch_counts()
        assert not any(counts[k] for k in TPU_KERNELS), (name, counts)
        main_launches.update(counts)
        return counts

    tasks = {w: WORKLOADS[w](batch=1) for w in SWEEP_WORKLOADS}
    grids = hetero_grids()
    two = grids["two_class"]
    pair = [tasks["alexnet"], tasks["vit"]]
    uniform = mt.MultiTenantConfig(method="uniform")

    # (a) fig_hetero's multi-tenant leg (benchmarks/fig_hetero.py): the
    # fast profile's uniform inner solves, then the full profile's GA.
    reset_launch_counts()
    calls.clear()
    t0 = time.perf_counter()
    got = mt.solve_multitenant(pair, two, "edp", cfg=uniform)
    uni_s = time.perf_counter() - t0
    counts = leg_counts("fig_hetero_uniform")
    assert counts["netsim_waterfill"] == 1, counts
    assert set(calls) == {"cuda"}, dict(calls)
    t0 = time.perf_counter()
    want = mt.solve_multitenant(pair, two, "edp", cfg=uniform,
                                backend="numpy")
    uni_numpy_s = time.perf_counter() - t0
    assert got.assignment == want.assignment, (got.assignment,
                                               want.assignment)
    assert [d["slowdown"] for d in got.per_tenant] == \
        [d["slowdown"] for d in want.per_tenant]
    for f in ("objective", "latency", "energy", "edp"):
        assert math.isclose(getattr(got, f), getattr(want, f),
                            rel_tol=MT_RTOL), f
    for a, b in zip(got.per_tenant, want.per_tenant):
        assert math.isclose(a["edp"], b["edp"], rel_tol=MT_RTOL)
    log("multitenant", json.dumps({
        "leg": "fig_hetero_uniform", "assignment": got.assignment,
        "even_split": got.baseline["assignment"],
        "edp": got.edp, "even_split_edp": got.baseline["edp"],
        "slowdowns_bit_identical_to_numpy": True,
        "solve_s_torch_cuda (host clock)": uni_s,
        "solve_s_numpy (host clock)": uni_numpy_s,
        "waterfilling_launches": counts["netsim_waterfill"]}))

    ga_cfg = GAConfig(population=64, generations=60, seed=0)
    reset_launch_counts()
    calls.clear()
    t0 = time.perf_counter()
    res = mt.solve_multitenant(pair, two, "edp", cfg=mt.MultiTenantConfig(
        method="ga", cfg=ga_cfg))
    ga_s = time.perf_counter() - t0
    counts = leg_counts("fig_hetero_ga")
    assert counts["netsim_waterfill"] == 1, counts
    assert set(calls) == {"cuda"} and calls["cuda"] > 0, dict(calls)
    assert res.objective < res.baseline["edp"], (res.objective,
                                                 res.baseline)
    for part, (x0, x1) in zip(res.partitions, res.assignment):
        assert part.Px.shape[1] == x1 - x0
    log("multitenant", json.dumps({
        "leg": "fig_hetero_ga (P 64, G 60, seed 0)",
        "assignment": res.assignment, "edp": res.edp,
        "even_split_edp": res.baseline["edp"],
        "improvement_vs_even_split": res.baseline["edp"] / res.edp,
        "fitness_calls": dict(calls), "evaluations": res.evaluations,
        "solve_s_torch_cuda (host clock)": ga_s}))

    # (b) The paper's four workloads as four tenants on 16x16 type A:
    # every band assignment's contention in one launch.
    hw16 = make_hw("A", MT_GRID, "hbm")
    four = [tasks[w] for w in SWEEP_WORKLOADS]
    assignments = mt.band_assignments(MT_GRID, len(four),
                                      uniform.max_assignments)
    seen = []
    real = netsim_ops.waterfill

    def record(caps, inc, msgs, routes=None, link_bytes=True):
        seen.append((caps, msgs, routes))
        return real(caps, inc, msgs, routes=routes, link_bytes=link_bytes)

    reset_launch_counts()
    netsim_ops.waterfill = record
    try:
        t0 = time.perf_counter()
        got4 = mt.solve_multitenant(four, hw16, "edp", cfg=uniform)
        torch.cuda.synchronize()
        four_s = time.perf_counter() - t0
    finally:
        netsim_ops.waterfill = real
    counts = leg_counts("four_tenants")
    assert counts["netsim_waterfill"] == 1 and len(seen) == 1, counts
    t0 = time.perf_counter()
    want4 = mt.solve_multitenant(four, hw16, "edp", cfg=uniform,
                                 backend="numpy")
    four_numpy_s = time.perf_counter() - t0
    assert got4.assignment == want4.assignment, (got4.assignment,
                                                 want4.assignment)
    assert math.isclose(got4.edp, want4.edp, rel_tol=MT_RTOL)
    t0 = time.perf_counter()
    slow_numpy = np.stack([mt._contention_slowdowns(four, a, hw16)
                           for a in assignments])
    contention_numpy_s = time.perf_counter() - t0
    slow_card = mt._contention_slowdowns_batch(four, assignments, hw16)
    assert np.array_equal(slow_card, slow_numpy)
    caps, msgs, routes = seen[0]
    N, S, F = msgs.shape
    L, R = caps.shape[1], routes.shape[2]
    lat_k, done_k, _, rounds = waterfill(caps, routes, msgs,
                                         link_bytes=False)
    torch.cuda.synchronize()
    kernel_ms = time_ms(lambda: waterfill(caps, routes, msgs,
                                          link_bytes=False), reps=10)
    kernel_burst = burst_ms(lambda: waterfill(caps, routes, msgs,
                                              link_bytes=False),
                            calls=10, reps=3)
    _, dinc, _ = hw16.topology.flow_net()
    inc = torch.from_numpy(dinc[None]).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat_p, done_p, _, rounds_p = waterfill_ref(caps, inc, msgs,
                                               link_bytes=False)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    assert torch.equal(rounds, rounds_p)
    assert torch.equal(lat_k, lat_p) and torch.equal(done_k, done_p)
    zero = msgs == 0
    assert bool((done_k[zero] == 0).all())     # idle flows end at t = 0
    probe_rounds = 20000
    probe_ms = burst_ms(lambda: step_probe(probe_rounds, F, caps.device),
                        calls=5, reps=3)
    round_us = 1e3 * probe_ms / probe_rounds
    resident = (torch.cuda.get_device_properties(0).multi_processor_count
                * blocks_per_sm(F, L, R))
    r = rounds.cpu().numpy().astype(np.int64)
    rounds_ms = max(int(r.max()) * round_us,
                    int(r.sum()) * round_us / resident) / 1e3
    nbytes = (8 * N * L + 4 * N * F * R + 8 * N * S * F        # in
              + 8 * N * S + 8 * N * S * F + 4 * N * S)         # out
    bytes_ms = 1e3 * nbytes / H100_BYTES_PER_S
    contention = {
        "shape": {"networks": N, "simulations": S, "F": F, "L": L, "R": R,
                  "assignments": len(assignments),
                  "resident_blocks": resident},
        "kernel_ms": kernel_ms, "kernel_burst_ms": kernel_burst,
        "plain_ms": plain_ms,
        "rounds_max": int(r.max()), "rounds_mean": float(r.mean()),
        "round_us": round_us, "bound_ms": max(rounds_ms, bytes_ms),
        "rounds_bound_ms": rounds_ms, "bytes_bound_ms": bytes_ms,
        "bound_by": "operations" if rounds_ms >= bytes_ms else "bytes",
        "max_abs_err": max(float((lat_k - lat_p).abs().max()),
                           float((done_k - done_p).abs().max())),
        "bit_identical_to_plain": True, "library_ms": None}
    log("multitenant", json.dumps({
        "leg": "four_tenants_16x16_uniform",
        "assignment": got4.assignment,
        "slowdowns": [d["slowdown"] for d in got4.per_tenant],
        "edp": got4.edp, "even_split_edp": got4.baseline["edp"],
        "contention_launches": counts["netsim_waterfill"],
        "slowdowns_bit_identical_to_numpy (all assignments)": True,
        "solve_s_torch_cuda (host clock)": four_s,
        "solve_s_numpy (host clock)": four_numpy_s,
        "contention_s_numpy_per_assignment_loop (host clock)":
            contention_numpy_s}))
    log("multitenant", "netsim_waterfill at the contention launch "
        + json.dumps(contention))

    # (c) The optimisation server on the card: the CLI demo's traffic,
    # fig_hetero's GA points as solve requests and (b) as a multi-tenant
    # request, plus one malformed request.
    ga_opts = EvalOptions(redistribution=True, async_exec=True)
    het_pts = [sweep.EvalPoint(tasks[w], hw, ga_opts)
               for w in ("alexnet", "vit") for hw in grids.values()]
    reqs = optserver._demo_requests(SERVE_DEMO_REQUESTS)
    reqs += [OptRequest("solve", pt, objective="edp", method="ga",
                        cfg=ga_cfg) for pt in het_pts]
    reqs.append(OptRequest("solve", sweep.MultiTenantPoint(tuple(four),
                                                           hw16),
                           objective="edp", method="multitenant",
                           cfg=uniform))
    t0 = time.perf_counter()
    solo = [_solo(q) for q in reqs[:-1]] + [got4]
    solo_s = time.perf_counter() - t0
    bad_task = tasks["alexnet"]
    bad_part = uniform_partition(bad_task, 4, 4)
    bad_part.Px[0, 0] += 7
    bad = OptRequest("eval", sweep.EvalPoint(bad_task, make_hw("A", 4,
                                                                "hbm"),
                                             partition=bad_part))
    store = ROOT / "build" / "phase9-sweep-cache.bin"
    store.parent.mkdir(parents=True, exist_ok=True)
    if store.exists():
        os.remove(store)
    sweep.clear_cache()
    reset_launch_counts()
    srv = OptServer(store_path=str(store), max_batch=len(reqs) + 1,
                    autostart=False)
    futs = [srv.submit(q) for q in reqs[:10]] + [srv.submit(bad)] + \
        [srv.submit(q) for q in reqs[10:]]
    bad_fut = futs.pop(10)
    srv.start()
    served = [f.result(timeout=SERVE_WAIT_S) for f in futs]
    try:
        bad_fut.result(timeout=SERVE_WAIT_S)
        raise AssertionError("a malformed request was served")
    except BadRequest:
        pass
    assert srv.drain(timeout=SERVE_WAIT_S)
    stats = srv.stats()
    srv.kill()
    counts = leg_counts("server")
    assert counts["netsim_waterfill"] == 1, counts
    pipe_groups = {(len(q.point.segments), int(q.point.batch))
                   for q in reqs if q.kind == "pipeline"}
    assert counts["sgs_batch"] == len(pipe_groups), (counts, pipe_groups)
    same = [_same_record(a, b) for a, b in zip(solo, served)]
    assert all(same), [q.kind for q, ok in zip(reqs, same) if not ok]
    assert stats["completed"] == len(reqs) and stats["rejected"] == 1
    # Restart on the store: everything served again from it, no launch.
    sweep.clear_cache()
    reset_launch_counts()
    srv2 = OptServer(store_path=str(store), max_batch=len(reqs))
    loaded = srv2.store_info["loaded"]
    again = [f.result(timeout=SERVE_WAIT_S)
             for f in [srv2.submit(q) for q in reqs]]
    stats2 = srv2.stats()
    srv2.close(timeout=SERVE_WAIT_S)
    relaunched = launch_counts()
    assert not any(relaunched.values()), relaunched
    assert stats2["cache_misses"] == 0, stats2
    assert all(_same_record(a, b) for a, b in zip(served, again))
    keep = ("completed", "rejected", "batches", "requests_per_s", "p50_ms",
            "p99_ms", "coalesce_factor", "cache_hits", "cache_misses",
            "cache_hit_rate", "stragglers", "batch_ewma_s", "elapsed_s")
    log("multitenant", json.dumps({
        "leg": "optserver", "requests": len(reqs) + 1,
        "kinds": dict(collections.Counter(q.kind + "/" + q.method
                                          if q.kind == "solve" else q.kind
                                          for q in reqs)),
        "served_equals_solo_bitwise": True,
        "solo_calls_s (host clock)": solo_s,
        "stats (host clock)": {k: stats[k] for k in keep},
        "launches": {k: v for k, v in counts.items() if v},
        "malformed_request": "BadRequest on its own future",
        "restart": {"store_entries_loaded": loaded,
                    "cache_hits": stats2["cache_hits"],
                    "cache_misses": stats2["cache_misses"],
                    "kernel_launches": sum(relaunched.values()),
                    "p50_ms (host clock)": stats2["p50_ms"]}}))

    # (d) devices="sharded": the card listed once and three times.
    flow = EvalOptions(congestion="flow", redistribution=True,
                       async_exec=True)
    rates = np.random.default_rng(0).uniform(48.0, 128.0, 5)
    eval_pts = [sweep.EvalPoint(tasks["vit"], make_hw("A", 4, "hbm",
                                                      bw_nop=b), o)
                for o in (ga_opts, flow) for b in rates]
    GB = 1e9
    nets = [fig3_net(m, p, b * GB) for m in ("dram", "hbm")
            for p in ("peripheral", "central") for b in (60, 120)]
    rng = np.random.default_rng(1)
    pipe_pts = [sweep.PipelinePoint(
        [(f"op{i}", *rng.uniform(1e-6, 1e-4, 3)) for i in range(16)], 8)
        for _ in range(5)]
    lat_pts = [sweep.EvalPoint(tasks["alexnet"], make_hw("A", 4, "hbm",
                                                         bw_nop=b))
               for b in rates[:3]]
    miqp_cfg = MIQPConfig(candidate_budget=4096, eval_budget=8192,
                          backend="torch")
    shard_ga = GAConfig(**SHARD_GA)
    engines = {
        "eval": lambda d: sweep.eval_sweep(eval_pts, cache=False,
                                           devices=d),
        "ga_islands": lambda d: sweep.solve_grid(
            het_pts, "edp", shard_ga, backend="torch", cache=False,
            devices=d),
        "netsim": lambda d: sweep.netsim_sweep(nets, GB, cache=False,
                                               devices=d),
        "sgs": lambda d: sweep.pipeline_sweep(pipe_pts, cache=False,
                                              devices=d),
        "lattice": lambda d: sweep.solve_grid(
            lat_pts, "latency", miqp_cfg, cache=False, method="miqp",
            devices=d),
    }
    shard_log = {}
    for name, run in engines.items():
        reset_launch_counts()
        t0 = time.perf_counter()
        single = run("single")
        single_s = time.perf_counter() - t0
        row = {"points": len(single), "single_s": single_s,
               "single_launches": {k: v for k, v in launch_counts().items()
                                   if v}}
        for k in SHARD_MESHES:
            reset_launch_counts()
            with sweep_shard.use_mesh([torch.device("cuda", 0)] * k):
                t0 = time.perf_counter()
                out = run("sharded")
                row[f"sharded_x{k}_s"] = time.perf_counter() - t0
            counts = leg_counts(f"sharded_{name}_{k}")
            row[f"sharded_x{k}_launches"] = {c: v for c, v in counts.items()
                                             if v}
            ok = all(_same_record(a, b) if not isinstance(a, dict)
                     or "done" not in a else
                     (a["latency"] == b["latency"]
                      and np.array_equal(a["done"], b["done"])
                      and np.array_equal(a["link_bytes"], b["link_bytes"]))
                     for a, b in zip(single, out))
            assert ok, (name, k)
        shard_log[name] = row
    log("multitenant", json.dumps({
        "leg": "devices_sharded (host clock)",
        "meshes": [f"cuda:0 x {k}" for k in SHARD_MESHES],
        "bit_identical_to_single": True, **shard_log}))
    assert not any(launch_counts()[k] for k in TPU_KERNELS)
    log("multitenant", f"phase 9 in {time.perf_counter() - t_phase:.1f}s")
    return dict(main_launches), contention


# Phase 10: the fused co-search (repro_torch.core.cosearch, DESIGN.md
# §16) on DESIGN.md §16's fig13 grid: alexnet, vit and hydranet at batch
# 1 on a 4x4 type-A HBM MCM (the paper's size, not cut), population 48,
# patience 8 (the other budgets CoSearchConfig's defaults: 64
# generations, 32 descent steps from 4 starts, batch 4, archive 32).
COSEARCH_WORKLOADS = ("alexnet", "vit", "hydranet")
COSEARCH_CFG = dict(population=48, patience=8)
COSEARCH_RTOL = 1e-9


def host_rescore(task, hw, options, genome, batch, seg_overhead=0.0):
    """A co-search genome (partition, redist mask, diag, seg mask)
    through the port's numpy evaluator and the serial heap SGS
    (pipelining.list_schedule): (edp, latency, energy)."""
    import dataclasses

    from repro_torch.core import pipelining
    from repro_torch.core.evaluator import Evaluator
    part, rd, diag, seg = genome
    ev = Evaluator(task, dataclasses.replace(hw, diagonal_links=diag),
                   options, backend="numpy").evaluate(part, rd)
    n = len(task)
    seg_id = np.concatenate([[0], np.cumsum(seg[:-1])]).astype(int)
    slots = np.zeros((n, 3))
    for i in range(n):
        slots[seg_id[i]] += (ev.t_in[i], ev.t_comp[i], ev.t_out[i])
    slots[:seg_id[-1] + 1, 0] += seg_overhead
    mk, _ = pipelining.list_schedule(pipelining.build_jobs(
        [(f"s{k}", *slots[k]) for k in range(n)], batch))
    lat = mk / batch
    return ev.energy * lat, lat, ev.energy


def same_cosearch(a, b):
    return (a.objective == b.objective and a.diagonal == b.diagonal
            and (a.edp, a.latency, a.energy) == (b.edp, b.latency, b.energy)
            and np.array_equal(a.partition.Px, b.partition.Px)
            and np.array_equal(a.partition.Py, b.partition.Py)
            and np.array_equal(a.partition.collectors, b.partition.collectors)
            and np.array_equal(a.redist_mask, b.redist_mask)
            and np.array_equal(a.seg_mask, b.seg_mask)
            and a.front.keys() == b.front.keys()
            and all(np.array_equal(a.front[k], b.front[k]) for k in a.front)
            and np.array_equal(a.history, b.history)
            and a.evaluations == b.evaluations)


def phase_cosearch():
    """Phase 10: the fused co-search on the card. One cosearch_sweep over
    DESIGN.md §16's fig13 grid (each workload its own shape group, so
    one island each), timed per workload on the host clock, with its
    gradient seeding timed apart; every generation one SGS launch. Each
    best genome re-scored by numpy + the serial SGS at rtol 1e-9, each
    front non-dominated, each best EDP at most the better uniform
    baseline row's; each workload's evolution re-run from the same
    seeds under torch.profiler (kernels a generation, host waits, busy
    share) and equal to the sweep's record; two alexnet points of one
    shape solved together equal their solo records; one flow search on
    alexnet, one waterfilling launch a generation, re-scored by the
    numpy flow evaluator. No TPU kernel launches."""
    import dataclasses

    from repro_torch.core import api, evaluator_torch, sweep
    from repro_torch.core import cosearch as cs
    from repro_torch.core.evaluator import EvalOptions, Evaluator
    from repro_torch.core.hw import make_hw
    from repro_torch.core.workload import Partition
    from repro_torch.graphs import WORKLOADS
    from repro_torch.kernels.netsim.kernel import waterfill
    from repro_torch.kernels.sgs.kernel import sgs_batch

    t_phase = time.perf_counter()
    sweep.clear_cache()
    main_launches = collections.Counter()
    hw = make_hw("A", 4, "hbm")
    opts = EvalOptions(redistribution=True, async_exec=True)
    cfg = cs.CoSearchConfig(**COSEARCH_CFG)
    tasks = {w: WORKLOADS[w](batch=1) for w in COSEARCH_WORKLOADS}

    # Wrap the module's entry points to time each workload's search and
    # its seeding, count generation steps and keep the seeds.
    real_islands, real_seeds, real_apply = (cs.cosearch_islands,
                                            cs.gradient_seeds, cs._apply)
    log_rows, seeds, applied = {}, {}, [0]

    def timed_islands(tasks_, hws_, *a, **kw):
        name = tasks_[0].name
        applied[0] = 0
        sgs0, wf0 = sgs_batch.launches, waterfill.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_islands(tasks_, hws_, *a, **kw)
        torch.cuda.synchronize()
        row = log_rows.setdefault(name, {})
        row.update({"wall_s": time.perf_counter() - t0,
                    "generation_steps": applied[0],
                    "sgs_launches": sgs_batch.launches - sgs0,
                    "waterfill_launches": waterfill.launches - wf0})
        return out

    def timed_seeds(task, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_seeds(task, *a, **kw)
        torch.cuda.synchronize()
        log_rows.setdefault(task.name, {})["seeding_s"] = \
            time.perf_counter() - t0
        seeds[task.name] = out
        return out

    def counted_apply(*a, **kw):
        applied[0] += 1
        return real_apply(*a, **kw)

    cs.cosearch_islands, cs.gradient_seeds, cs._apply = (
        timed_islands, timed_seeds, counted_apply)
    calls = evaluator_torch.grid_evaluate.calls
    try:
        reset_launch_counts()
        calls.clear()
        t0 = time.perf_counter()
        recs = sweep.cosearch_sweep(
            [sweep.EvalPoint(tasks[w], hw, opts) for w in tasks], "edp", cfg)
        sweep_s = time.perf_counter() - t0
        fitness_calls = dict(calls)
        # Every fitness call (generation steps and descent steps) on cuda.
        assert set(fitness_calls) == {"cuda"}, fitness_calls
        counts = launch_counts()
        assert not any(counts[k] for k in TPU_KERNELS), counts
        main_launches.update(counts)

        # The profiled re-runs: the same seeds, so the same records.
        prof = {}
        for w, r in zip(tasks, recs):
            applied[0] = 0
            box = []
            prof[w] = ga_profile(lambda: box.append(real_islands(
                [tasks[w]], [hw], opts, "edp", cfg,
                seeds=[seeds[tasks[w].name]])[0]),
                1, 0)
            steps = applied[0]
            prof[w].update({
                "generation_steps": steps,
                "chunks": -(-steps // cfg.patience),
                "kernels_per_generation":
                    prof[w]["kernels_per_generation"] / steps})
            assert same_cosearch(box[0], r), w
        # The host waits for the card once a chunk, nowhere else.
        applied[0] = 0
        syncs = counted_syncs(lambda: real_islands(
            [tasks["alexnet"]], [hw], opts, "edp", cfg,
            seeds=[seeds[tasks["alexnet"].name]]))
        sync_chunks = -(-applied[0] // cfg.patience)
        assert syncs == sync_chunks, (syncs, sync_chunks)
        seed_prof = device_breakdown(lambda: real_seeds(
            tasks["vit"], hw, opts, "edp", cfg))
    finally:
        cs.cosearch_islands, cs.gradient_seeds, cs._apply = (
            real_islands, real_seeds, real_apply)

    for w, r in zip(tasks, recs):
        t = tasks[w]
        row = log_rows[t.name]
        assert row["sgs_launches"] == row["generation_steps"], (w, row)
        got = host_rescore(t, hw, opts, (r.partition, r.redist_mask,
                                         r.diagonal, r.seg_mask), cfg.batch)
        err = max(abs(g - v) / abs(v) for g, v in
                  zip(got, (r.edp, r.latency, r.energy)))
        assert err <= COSEARCH_RTOL, (w, got, r.edp, r.latency, r.energy)
        pts = np.stack([r.front[k] for k in cs.OBJECTIVES], 1)
        assert cs.pareto_mask(pts).all(), w
        assert r.front["edp"].min() == r.edp, w
        Px, Py, co, rd, dg, sg = cs._init_island(t, hw, opts, cfg, [])
        valid = Evaluator(t, hw, opts, backend="numpy").chain_valid
        base = []
        for row_i in (0, 1):
            part = Partition(Px[row_i].astype(np.int64),
                             Py[row_i].astype(np.int64),
                             co[row_i].astype(np.int64))
            rdm = rd[row_i].astype(bool) & valid
            base.append(host_rescore(t, hw, opts, (part, rdm,
                                                   bool(dg[row_i]),
                                                   sg[row_i] > 0.5),
                                     cfg.batch)[0])
        assert r.edp <= min(base) * (1 + COSEARCH_RTOL), (w, r.edp, base)
        row.update({"generations": len(r.history),
                    "sgs_launches_per_generation": row["sgs_launches"]
                    / row["generation_steps"],
                    "front_size": len(r.front["edp"]),
                    "best_edp": r.edp, "latency": r.latency,
                    "energy": r.energy, "diagonal": r.diagonal,
                    "segments": int(r.seg_mask.sum()) + 1,
                    "uniform_rows_edp (plain 1 seg, diag per-op)": base,
                    "rescore_max_rel_err": err,
                    "seeds": len(seeds[t.name]),
                    "profiled_evolution": prof[w]})
        log("cosearch", json.dumps({"workload": w, "ops": len(t),
                                    **row}))
    log("cosearch", json.dumps({
        "leg": "fig13 cosearch_sweep (host clock)", "points": len(recs),
        "sweep_s": sweep_s, "config": COSEARCH_CFG,
        "launches": {k: v for k, v in counts.items() if v},
        "evaluator_calls": fitness_calls,
        "host_syncs_alexnet_evolution": syncs, "chunks": sync_chunks,
        "seeding_vit_profiled": seed_prof}))

    # Solo == batched on the card: two alexnet points of one shape.
    pair = [tasks["alexnet"], WORKLOADS["alexnet"](batch=2)]
    reset_launch_counts()
    t0 = time.perf_counter()
    batched = cs.cosearch_islands(pair, [hw, hw], opts, "edp", cfg)
    batched_s = time.perf_counter() - t0
    solo = [recs[0], cs.run_cosearch(pair[1], hw, "edp", opts, cfg)]
    assert all(same_cosearch(a, b) for a, b in zip(solo, batched))
    counts = launch_counts()
    assert not any(counts[k] for k in TPU_KERNELS), counts
    main_launches.update(counts)
    log("cosearch", json.dumps({
        "leg": "solo == batched (alexnet batch 1 and 2)",
        "bit_identical": True, "batched_s": batched_s}))

    # One flow-congestion search on alexnet: the waterfilling kernel
    # once a generation beside the SGS kernel.
    flow = dataclasses.replace(opts, congestion="flow")
    reset_launch_counts()
    applied[0] = 0
    cs._apply = counted_apply
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fr = api.cosearch(tasks["alexnet"], hw, "edp", flow, cfg)
        torch.cuda.synchronize()
        flow_s = time.perf_counter() - t0
    finally:
        cs._apply = real_apply
    counts = launch_counts()
    assert not any(counts[k] for k in TPU_KERNELS), counts
    assert counts["sgs_batch"] == applied[0], (counts, applied[0])
    assert counts["netsim_waterfill"] == applied[0], (counts, applied[0])
    main_launches.update(counts)
    got = host_rescore(tasks["alexnet"], hw, flow,
                       (fr.partition, fr.redist_mask, fr.diagonal,
                        fr.seg_mask), cfg.batch)
    ferr = max(abs(g - v) / abs(v)
               for g, v in zip(got, (fr.edp, fr.latency, fr.energy)))
    assert ferr <= COSEARCH_RTOL, (got, fr.edp)
    assert cs.pareto_mask(np.stack([fr.front[k] for k in cs.OBJECTIVES],
                                   1)).all()
    log("cosearch", json.dumps({
        "leg": "alexnet under congestion='flow' (host clock)",
        "wall_s": flow_s, "generations": len(fr.history),
        "generation_steps": applied[0],
        "launches": {k: v for k, v in counts.items() if v},
        "best_edp": fr.edp, "regime_best_edp": recs[0].edp,
        "front_size": len(fr.front["edp"]), "diagonal": fr.diagonal,
        "rescore_max_rel_err": ferr}))
    assert not any(main_launches[k] for k in TPU_KERNELS)
    log("cosearch", f"phase 10 in {time.perf_counter() - t_phase:.1f}s")
    return dict(main_launches)


# Phase 11: the trainer. smollm-360m at full width and depth through
# repro_torch.launch.train.main (batch 8, seq 2048, 10 steps, a
# checkpoint every 5), then a restart with --restore auto for 4 steps;
# rwkv6-3b and zamba2-2.7b at published widths and reduced depth (2 RWKV-6
# layers; one Mamba-2 group and its shared attention block), 3 steps each.
# With cfg.remat each block's forward runs again in the backward, so a
# kernel launches twice per layer and step; the kernels' backward is the
# plain version's autograd and launches nothing.
TRAIN_SMOLLM = dict(batch=8, seq=2048, steps=10, ckpt_every=5, restart=4,
                    warmup=2, lr=3e-3)
TRAIN_CUT = {"rwkv6-3b": dict(n_layers=2), "zamba2-2.7b": dict(n_layers=6)}
TRAIN_CUT_SHAPE = dict(batch=4, seq=1024, steps=3)
# The first smollm step through the kernels against the same step through
# the plain versions on the card, bf16 compute: the loss within
# TRAIN_LOSS_RTOL, the global grad norm within TRAIN_GNORM_RTOL and every
# parameter's grad norm within TRAIN_PARAM_RTOL (the kernels round in
# other places than the plain versions, and a random-weight model
# carries a change on through 32 layers). A planted fault, the flash
# backward returning a zero dk, must break the last limit.
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GNORM_RTOL = 5e-2
TRAIN_PARAM_RTOL = 0.1


def train_launches_per_step(cfg):
    """Kernel launches of one training step, reckoned from the code: one
    per kernel-running layer in the forward, and one more in the backward
    when cfg.remat recomputes the block."""
    per = 2 if cfg.remat else 1
    if cfg.family == "ssm":
        return {"wkv6": per * cfg.n_layers}
    if cfg.family == "hybrid":
        return {"ssm_scan": per * cfg.n_layers,
                "flash_attention": per * cfg.n_layers
                // cfg.hybrid_attn_period}
    return {"flash_attention": per * cfg.n_layers}


def check_launches(cfg, counts, steps, what):
    """``steps``: the steps run, rejected ones included."""
    want = {k: v * steps for k, v in train_launches_per_step(cfg).items()}
    got = {k: v for k, v in counts.items() if v}
    log("train", f"{what}: launches per step reckoned "
        f"{train_launches_per_step(cfg)}, counted over {steps} steps "
        f"{got}")
    assert got == want, f"{what}: launched {got}, expected {want}"


def grad_norms(grads):
    return {n: g.float().norm().item() for n, g in grads.items()}


def first_step_vs_plain(cfg, batch):
    """The first smollm step's loss and gradients through the kernels
    and through the plain versions (ops.attention's CPU route forced on
    the card), and with a planted fault; the limits above."""
    from repro_torch.kernels.flash_attention import blockwise, ops
    from repro_torch.models import init_model
    from repro_torch.train.train_step import grads_of, to_device

    params = dict(init_model(cfg, seed=0, device="cuda",
                             train=True).named_parameters())
    batch = to_device(batch, "cuda")

    def run():
        g, m = grads_of(cfg, params, batch)
        norms = grad_norms(g)
        total = math.sqrt(sum(v * v for v in norms.values()))
        return m["loss"].item(), total, norms

    kernel = run()
    kernel_attention = ops.attention
    ops.attention = lambda q, k, v, **kw: blockwise.blockwise_attention(
        q, k, v, **kw)
    try:
        plain = run()
    finally:
        ops.attention = kernel_attention
    backward = ops.FlashAttention.backward

    def zero_dk(ctx, grad_out):
        dq, dk, *rest = backward(ctx, grad_out)
        return (dq, torch.zeros_like(dk), *rest)
    ops.FlashAttention.backward = staticmethod(zero_dk)
    try:
        fault = run()
    finally:
        ops.FlashAttention.backward = staticmethod(backward)

    def worst(a, b):
        rel = {n: abs(a[2][n] - b[2][n]) / max(b[2][n], 1e-30) for n in b[2]}
        name = max(rel, key=rel.get)
        return name, rel[name]
    loss_rel = abs(kernel[0] - plain[0]) / abs(plain[0])
    gnorm_rel = abs(kernel[1] - plain[1]) / plain[1]
    name, param_rel = worst(kernel, plain)
    fname, fault_rel = worst(fault, plain)
    log("train", json.dumps({
        "first_step_kernel_vs_plain": {
            "loss": [kernel[0], plain[0]], "loss_rel": loss_rel,
            "grad_norm": [kernel[1], plain[1]], "grad_norm_rel": gnorm_rel,
            "worst_param": name, "worst_param_rel": param_rel,
            "limits": [TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_PARAM_RTOL]},
        "planted_zero_dk": {"worst_param": fname,
                            "worst_param_rel": fault_rel}}))
    assert loss_rel <= TRAIN_LOSS_RTOL, loss_rel
    assert gnorm_rel <= TRAIN_GNORM_RTOL, gnorm_rel
    assert param_rel <= TRAIN_PARAM_RTOL, (name, param_rel)
    assert fault_rel > TRAIN_PARAM_RTOL, ("planted fault not rejected",
                                          fname, fault_rel)
    return kernel[0]


def phase_train():
    """smollm-360m trained and restarted through launch.train.main (the
    launches of its runs counted and checked), the first step held to the
    plain versions, one step profiled; then the cut rwkv6-3b and
    zamba2-2.7b, 3 steps each through the same train step and loop."""
    import contextlib
    import io
    import shutil
    import tempfile

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.launch import train as train_mod
    from repro_torch.models import init_model
    from repro_torch.runtime import FaultTolerantLoop
    from repro_torch.train import adamw, cosine_schedule
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)

    t_phase = time.perf_counter()
    total = collections.Counter()
    cfg = get_config("smollm-360m")
    tr = TRAIN_SMOLLM
    (ROOT / "build").mkdir(exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="train-ckpt-", dir=ROOT / "build")
    args = ["--arch", cfg.name, "--batch", str(tr["batch"]), "--seq",
            str(tr["seq"]), "--lr", str(tr["lr"]), "--warmup",
            str(tr["warmup"]), "--ckpt", ckdir, "--log-every", "1"]
    try:
        reports = []
        for run, extra in (("first run", ["--steps", str(tr["steps"]),
                                          "--ckpt-every",
                                          str(tr["ckpt_every"])]),
                           ("restart", ["--steps", str(tr["restart"]),
                                        "--restore", "auto"])):
            torch.cuda.synchronize()
            reset_launch_counts()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                report = train_mod.main(args + extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
            peak = torch.cuda.max_memory_allocated()
            for line in out.getvalue().splitlines():
                log("train", line)
            check_launches(cfg, counts, report.steps_run + report.bad_steps,
                           f"{cfg.name} {run}")
            total.update(counts)
            steady = report.step_s[1:]
            step_ms = 1e3 * statistics.median(steady)
            row = {"arch": cfg.name, "run": run, "layers": cfg.n_layers,
                   "d_model": cfg.d_model, "batch": tr["batch"],
                   "seq": tr["seq"], "steps_run": report.steps_run,
                   "bad_steps": report.bad_steps,
                   "restores": report.restores,
                   "stragglers": report.stragglers,
                   "losses": report.losses,
                   "step_ms": [1e3 * s for s in report.step_s],
                   "steady_step_ms": step_ms,
                   "tokens_per_s": tr["batch"] * tr["seq"] / step_ms * 1e3,
                   "wall_s": wall, "max_memory_allocated_bytes": peak,
                   "checkpoints": Checkpointer(ckdir).steps(),
                   "card": CARD}
            log("train", json.dumps(row))
            assert all(math.isfinite(x) for x in report.losses), row
            assert report.bad_steps == 0 and report.restores == 0, row
            reports.append((report, out.getvalue()))
        (first, _), (again, again_out) = reports
        assert first.steps_run == tr["steps"]
        assert first.losses[-1] < first.losses[0], first.losses
        assert f"[train] restored step {tr['steps']}" in again_out
        assert again.steps_run == tr["restart"]
        assert Checkpointer(ckdir).latest() == tr["steps"] + tr["restart"]
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)

    pipe = make_pipeline(cfg, dict(seq_len=tr["seq"],
                                   global_batch=tr["batch"]), seed=0)
    first_loss = first_step_vs_plain(cfg, pipe.at(0))
    rel = abs(first_loss - first.losses[0]) / abs(first.losses[0])
    log("train", f"first step's loss by grads_of {first_loss} vs the "
        f"driver's {first.losses[0]} (rel {rel:.2e})")
    assert rel <= TRAIN_LOSS_RTOL

    # One warm step profiled: the device's busy share.
    opt = adamw(lr=cosine_schedule(tr["lr"], tr["warmup"], tr["steps"]))
    step = make_train_step(cfg, opt)
    state = init_train_state(dict(init_model(
        cfg, seed=0, device="cuda", train=True).named_parameters()), opt)
    state, _ = step(state, pipe.at(0))
    batch = pipe.at(1)
    prof = device_breakdown(lambda: step(state, batch))
    log("train", f"{cfg.name} one warm step profiled " + json.dumps(prof))
    del state, step
    torch.cuda.empty_cache()

    for arch, cut in TRAIN_CUT.items():
        cfg = get_config(arch).replace(**cut)
        sh = TRAIN_CUT_SHAPE
        opt = adamw(lr=cosine_schedule(tr["lr"], 1, sh["steps"]))
        model = init_model(cfg, seed=0, device="cuda", train=True)
        n_params = sum(p.numel() for p in model.parameters())
        state = init_train_state(dict(model.named_parameters()), opt)
        del model
        pipe = make_pipeline(cfg, dict(seq_len=sh["seq"],
                                       global_batch=sh["batch"]), seed=0)
        loop = FaultTolerantLoop(make_train_step(cfg, opt), pipe,
                                 log=lambda m: log("train", m))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        state, report = loop.run(state, 0, sh["steps"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        check_launches(cfg, counts, report.steps_run + report.bad_steps,
                       arch)
        total.update(counts)
        step_ms = 1e3 * statistics.median(report.step_s[1:])
        row = {"arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
               "parameters": n_params, **sh,
               "steps_run": report.steps_run, "losses": report.losses,
               "step_ms": [1e3 * s for s in report.step_s],
               "steady_step_ms": step_ms,
               "tokens_per_s": sh["batch"] * sh["seq"] / step_ms * 1e3,
               "wall_s": wall,
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
               "card": CARD}
        log("train", json.dumps(row))
        assert report.steps_run == sh["steps"], row
        assert all(math.isfinite(x) for x in report.losses), row
        del state, loop
        torch.cuda.empty_cache()
    log("train", f"phase 11 in {time.perf_counter() - t_phase:.1f}s")
    return total


# Phase 12. The fake-world dry runs: (arch, shape, multi-pod, layers,
# knobs). Depth is cut to fit the phase's time: the trace runs every op of
# the step in Python (~1 ms an op); the CLI traces full depth.
MESH_DRYRUNS = (
    ("smollm-360m", "train_4k", False, 2, {}),
    ("deepseek-v2-236b", "train_4k", True, 2, {"accum": 1}),
    ("minicpm3-4b", "prefill_32k", False, 2,
     {"cfg_overrides": {"attn_chunk": 4096}, "perf": True}),
    # accumulation over the global batch's microbatches, whose frames are
    # activation-sized: each input gathered once a step
    ("hubert-xlarge", "train_4k", False, 2, {"accum": 2}),
)
# execute_plan's cell on the card, and the mesh trainer's run.
MESH_PLAN = dict(arch="smollm-360m", layers=2, seq=512, batch=8)
MESH_TRAIN = dict(layers=4, batch=8, seq=512, steps=3)
# The mesh trainer on the (1, 1) mesh against the meshless one: the same
# ops on the same shards, bf16 compute (the regions change no order of a
# sum on one rank).
MESH_LOSS_RTOL = 1e-4
# Allocated argument bytes against the specs' prediction.
MESH_ARG_RTOL = 0.01
# Reduced minicpm3-4b's prefill on the card's (1, 1) mesh under the
# attn_qchunk rule (rows of each 32-row query chunk over model, of size 1
# here: one launch a chunk at its offset), against the meshless prefill
# (one launch a layer): f32 within QCHUNK_F32_RTOL of max |logit| (the
# same rows, the same key tiles), bf16 within LOGIT_REL_TOL.
QCHUNK_PREFILL = dict(batch=4, seq=256)
QCHUNK_F32_RTOL = 1e-5


def _spec_bytes(cfg, kind, shape, mesh, knobs, arch):
    """The local shards' bytes of a cell's arguments, from the specs
    alone: parameters (and Adam's moments in the policies' dtypes, the
    step and its count), the batch, the caches."""
    from repro_torch.configs import SHAPE_DEFS
    from repro_torch.launch import dryrun
    from repro_torch.launch.policies import TRAIN_LOWMEM
    from repro_torch.models.transformer import Transformer, init_caches
    from repro_torch.sharding.logical import local_shape, sanitize_spec
    from repro_torch.sharding.partition_specs import (cache_shardings,
                                                      data_specs,
                                                      param_specs)

    def local(shape_, spec, itemsize):
        return math.prod(local_shape(shape_, spec, mesh)) * itemsize
    fsdp = ("pod", "data") if arch in TRAIN_LOWMEM else ("data",)
    if kind != "train" and knobs.get("serve_fsdp") is not None:
        fsdp = knobs["serve_fsdp"]
    params = dict(Transformer(cfg, "meta", train=True).named_parameters())
    specs = param_specs(cfg, params, mesh, fsdp)
    per = {n: p.element_size() for n, p in params.items()}
    if kind == "train":
        m_dt, v_dt = dryrun._moment_dtypes(arch)
        per = {n: b + m_dt.itemsize + v_dt.itemsize for n, b in per.items()}
    total = sum(local(p.shape, specs[n], per[n]) for n, p in params.items())
    if kind == "train":
        total += 2 * 4                           # the step and its count
    sd = SHAPE_DEFS[shape]
    B, S = sd["global_batch"], sd["seq_len"]
    if cfg.frontend == "audio_stub":
        inputs = [("frames", (B, S, cfg.frontend_dim), 2)]
        if kind == "train":
            inputs += [("mask", (B, S), 1), ("labels", (B, S), 8)]
    else:
        inputs = [("tokens", (B, 1 if kind == "decode" else S), 8)]
    total += sum(local(s, sanitize_spec(data_specs(mesh)[k], s, mesh), b)
                 for k, s, b in inputs)
    if kind in ("prefill", "decode"):
        caches = init_caches(cfg, B, S, dtype=torch.bfloat16, device="meta")
        cs = cache_shardings(caches, cfg, mesh)

        def walk(t, sp):
            return sum(walk(v, sp[k]) if isinstance(v, dict) else
                       local(v.shape, sp[k], v.element_size())
                       for k, v in t.items())
        total += walk(caches, cs)
    return total


# minicpm3-4b prefill_32k at 2 layers when the attn_qchunk rule was not
# read yet (PERF.md §6): every model rank attended every head.
QCHUNK_UNREAD = {"flops_per_device": 1.928e14, "temp_bytes": 38.0e9}


def _check_qchunk_dryrun(rec, cfg, shape, mesh):
    """The dry run of a cell under the attn_qchunk rule: the plain
    attention's FLOPs per device are those of its batch share (data) and
    its rows of each query chunk (model), every key, QKᵀ and PV at MLA's
    latent widths; logged beside the cell's record from before the rule
    was read."""
    from repro_torch.configs import SHAPE_DEFS
    from repro_torch.sharding.logical import axis_sizes

    sd, sizes = SHAPE_DEFS[shape], axis_sizes(mesh)
    S, B = sd["seq_len"], sd["global_batch"]
    dk = cfg.kv_lora_rank + cfg.qk_rope_dim
    want = (2 * cfg.n_layers * (B // sizes["data"]) * (S // sizes["model"])
            * cfg.n_heads * S * (dk + cfg.kv_lora_rank))
    got = rec["kernel_flops_per_device"]["flash_attention"]
    log("mesh", json.dumps({
        "attn_qchunk": rec["arch"], "shape": shape,
        "flops_per_device": rec["flops_per_device"],
        "temp_bytes": rec["memory"]["temp_size_in_bytes"],
        "attention_flops_per_device": got,
        "attention_flops_rows_split": want,
        "rule_not_read": QCHUNK_UNREAD}))
    assert got == want, (got, want)


def _mesh_dryruns():
    """The fake-world dry runs; → the fake (1, 1) record of execute_plan's
    cell."""
    import logging

    from repro_torch.configs import SHAPE_DEFS, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh

    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    for arch, shape, multi, layers, knobs in MESH_DRYRUNS:
        knobs = dict(knobs)
        if knobs.pop("perf", False):
            knobs.update(dryrun.perf_knobs(arch, shape))
        dryrun.ensure_fake_world(512 if multi else 256)
        mesh = make_production_mesh(multi_pod=multi)
        cfg = get_config(arch).replace(n_layers=layers)
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, "multi_pod_2x16x16" if multi
                              else "single_pod_16x16", mesh, cfg=cfg,
                              **knobs)
        wall = time.perf_counter() - t0
        want = _spec_bytes(cfg.replace(**knobs.get("cfg_overrides", {})),
                           rec["kind"], shape, mesh, knobs, arch)
        row = {k: rec[k] for k in ("arch", "shape", "mesh", "kind",
                                   "n_devices", "memory",
                                   "flops_per_device", "bytes_per_device",
                                   "collective_bytes_per_device",
                                   "lower_s", "compile_s")}
        log("mesh", json.dumps({**row, "layers": layers, "knobs": {
            k: v for k, v in knobs.items() if k != "extra_rules"},
            "spec_argument_bytes": want, "wall_s": wall}))
        assert rec["memory"]["argument_size_in_bytes"] == want, (
            rec["memory"], want)
        assert rec["flops_per_device"] > 0
        assert rec["collective_bytes_per_device"], rec
        if "attn_qchunk" in knobs.get("extra_rules", {}):
            _check_qchunk_dryrun(rec, cfg.replace(**knobs["cfg_overrides"]),
                                 shape, mesh)
    p = MESH_PLAN
    SHAPE_DEFS["__mesh_plan"] = dict(seq_len=p["seq"],
                                     global_batch=p["batch"], kind="prefill")
    dryrun.ensure_fake_world(1)
    cfg = get_config(p["arch"]).replace(n_layers=p["layers"])
    fake = dryrun.run_cell(p["arch"], "__mesh_plan", "fake_1x1",
                           make_debug_mesh(1), cfg=cfg)
    log("mesh", "fake (1, 1) " + json.dumps({
        k: fake[k] for k in ("memory", "flops_by_op",
                             "kernel_flops_per_device", "lower_s")}))
    import torch.distributed as dist
    dist.destroy_process_group()
    return fake


def _qchunk_prefill(mesh):
    """Reduced minicpm3-4b's prefill through ``run_cell``'s step on the
    card's (1, 1) NCCL mesh under the attn_qchunk rule, against the
    meshless prefill of the same seeded model and tokens: the logits,
    and flash launched once a query chunk (at its offset) against once a
    layer. → the launches of the mesh runs."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import SHAPE_DEFS, get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import forward, init_caches, init_model
    from repro_torch.sharding.logical import Spec

    qp = QCHUNK_PREFILL
    B, S = qp["batch"], qp["seq"]
    SHAPE_DEFS["__qchunk"] = dict(seq_len=S, global_batch=B, kind="prefill")
    rules = {"attn_qchunk": Spec(("data",), "model", None, None, None)}
    total = collections.Counter()
    for dtype, tol in (("float32", QCHUNK_F32_RTOL),
                       ("bfloat16", LOGIT_REL_TOL)):
        cfg = get_config("minicpm3-4b", reduced=True).replace(dtype=dtype)
        tok = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(0))
        with torch.no_grad():
            reset_launch_counts()
            want = forward(init_model(cfg, seed=0, device="cuda",
                                      train=True), {"tokens": tok},
                           mode="prefill", caches=init_caches(
                               cfg, B, S, device="cuda"))[0]
            plain_counts = launch_counts()
            cell, _ = dryrun.lower_cell("minicpm3-4b", "__qchunk", mesh,
                                        cfg=cfg, extra_rules=rules,
                                        materialize=True)
            params, batch, caches = cell.args
            batch["tokens"] = distribute_tensor(
                tok, mesh, batch["tokens"].placements, src_data_rank=None)
            torch.cuda.synchronize()
            reset_launch_counts()
            got = cell.run()[0].full_tensor()
            torch.cuda.synchronize()
            counts = launch_counts()
        total.update(counts)
        err = ((got.float() - want.float()).abs().max()
               / want.float().abs().max()).item()
        chunks = -(-S // cfg.attn_chunk)
        log("mesh", json.dumps({
            "attn_qchunk_prefill": cfg.name, "dtype": dtype, "batch": B,
            "seq": S, "layers": cfg.n_layers, "chunk": cfg.attn_chunk,
            "rel_err_vs_meshless": err, "bit_for_bit": torch.equal(got, want),
            "limit": tol, "launches": {k: v for k, v in counts.items() if v},
            "meshless_launches": {k: v for k, v in plain_counts.items()
                                  if v}}))
        assert counts["flash_attention"] == cfg.n_layers * chunks, counts
        assert plain_counts["flash_attention"] == cfg.n_layers, plain_counts
        assert sum(counts.values()) == counts["flash_attention"], counts
        assert torch.isfinite(got).all() and got.shape == want.shape
        assert err <= tol, (err, tol)
        del cell, params, batch, caches
    return total


def _check_compress(fn, g, err):
    """``fn(g, err)`` → (mean, new err) against dequantize(quantize(g +
    err)) on one rank, bit for bit; → whether it held."""
    from repro_torch.train.grad_compress import compress_residual
    q, scale, want_err = compress_residual(g, err)
    want = q.float() * scale
    got, got_err = fn(g, err)
    return torch.equal(got, want) and torch.equal(got_err, want_err)


def phase_mesh():
    import contextlib
    import io
    import socket

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding.mcm_planner import plan
    from repro_torch.train.grad_compress import compressed_all_reduce_mean

    t_phase = time.perf_counter()
    total = collections.Counter()
    fake = _mesh_dryruns()

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_debug_mesh(1)
        # the communicator is set up at the first collective: before the
        # allocations execute_plan measures
        dist.all_reduce(torch.ones(1, device="cuda"))
        p = MESH_PLAN
        cfg = get_config(p["arch"]).replace(n_layers=p["layers"])
        pr = plan(cfg, (1, 1), p["seq"], p["batch"], layers=p["layers"],
                  ga_budget=4)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reset_launch_counts()
        rec = dryrun.execute_plan(pr, p["arch"], "__mesh_plan", mesh,
                                  mesh_name="card_1x1", cfg=cfg)
        counts = launch_counts()
        total.update(counts)
        model = {k: v for k, v in rec["flops_by_op"].items()
                 if k in ("mm", "addmm", "bmm", "baddbmm")}
        fake_model = (fake["flops_per_device"]
                      - sum(fake["kernel_flops_per_device"].values()))
        pred = rec["memory"]["argument_size_in_bytes"]
        got = rec["measured"]["argument_bytes_allocated"]
        log("mesh", "execute_plan on the card " + json.dumps({
            "plan": rec["plan"], "launches": {k: v for k, v in
                                              counts.items() if v},
            "projection_flops": sum(model.values()),
            "fake_projection_flops": fake_model,
            "argument_bytes_predicted": pred,
            "argument_bytes_allocated": got,
            "peak_bytes_allocated": rec["measured"]["peak_bytes_allocated"],
            "peak_predicted": pred + rec["memory"]["temp_size_in_bytes"]
            + rec["memory"]["output_size_in_bytes"],
            "wall_s": rec["lower_s"], "card": CARD}))
        assert counts["flash_attention"] == p["layers"], counts
        assert sum(v for k, v in counts.items()
                   if k != "flash_attention") == 0, counts
        assert sum(model.values()) == fake_model, (model, fake_model)
        assert abs(got - pred) <= MESH_ARG_RTOL * pred, (got, pred)

        tr = MESH_TRAIN
        args = ["--arch", p["arch"], "--layers", str(tr["layers"]),
                "--batch", str(tr["batch"]), "--seq", str(tr["seq"]),
                "--steps", str(tr["steps"]), "--log-every", "1"]
        runs = {}
        for name, extra in (("meshless", []), ("mesh", ["--mesh", "debug"])):
            torch.cuda.synchronize()
            reset_launch_counts()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                report = train_mod.main(args + extra)
            torch.cuda.synchronize()
            counts = {k: v for k, v in launch_counts().items() if v}
            total.update(counts)
            runs[name] = (report, counts)
            log("mesh", json.dumps({
                "trainer": name, "layers": tr["layers"],
                "losses": report.losses, "launches": counts,
                "step_ms": [1e3 * x for x in report.step_s],
                "wall_s": time.perf_counter() - t0,
                "mesh_line": [ln for ln in out.getvalue().splitlines()
                              if "[train]" in ln][:1], "card": CARD}))
        (plain, pc), (meshed, mc) = runs["meshless"], runs["mesh"]
        assert pc == mc, (pc, mc)
        assert len(meshed.losses) == len(plain.losses) == tr["steps"]
        for a, b in zip(meshed.losses, plain.losses):
            assert abs(a - b) <= MESH_LOSS_RTOL * abs(b), (meshed.losses,
                                                           plain.losses)

        g = torch.Generator(device="cuda").manual_seed(5)
        grad = 3 * torch.randn(4096, 960, generator=g, device="cuda")
        err = 0.01 * torch.randn(4096, 960, generator=g, device="cuda")
        ok = _check_compress(compressed_all_reduce_mean, grad, err)
        fault = _check_compress(lambda x, e: compressed_all_reduce_mean(
            x, torch.zeros_like(e)), grad, err)
        log("mesh", json.dumps({"compressed_all_reduce_mean_1rank": ok,
                                "planted_err_dropped_rejected": not fault}))
        assert ok and not fault
        total.update(_qchunk_prefill(mesh))
    finally:
        dist.destroy_process_group()
    log("mesh", f"phase 12 in {time.perf_counter() - t_phase:.1f}s")
    return total


def phase_entry_points():
    """Phase 13: the port's counterparts of the JAX package's last two
    examples, each run once as a user runs it, on the card (the
    default), with every launch count at 0 just before and read just
    after: launch.plan_mesh (the calibration pass on the card, then every
    arch planned on a 16x16 grid of cards) and launch.optserve_client
    (evals under regime and flow, a GA solve and a pipeline through
    OptServer, then a warm restart served from its store through
    submit_async)."""
    import contextlib
    import io

    from repro_torch.configs import ARCHS
    from repro_torch.launch import optserve_client, plan_mesh

    total = collections.Counter()
    for name, fn in (("plan_mesh", lambda: plan_mesh.main([])),
                     ("optserve_client", lambda: optserve_client.main([]))):
        out = io.StringIO()
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in launch_counts().items() if v}
        total.update(counts)
        lines = out.getvalue().splitlines()
        log("entry", json.dumps({"entry_point": f"repro_torch.launch.{name}",
                                 "wall_s": wall, "launches": counts,
                                 "card": CARD}))
        for ln in lines:
            log("entry", ln)
        if name == "plan_mesh":
            assert set(res) == set(ARCHS), sorted(res)
            assert all(r.optimized_latency > 0 for r in res.values())
            assert counts == {k: v for k, v in CALIB_LAUNCHES.items() if v}, \
                counts
        else:
            # the store holds this process's whole sweep cache: every
            # request's entry and those of the phases before
            assert res["loaded"] >= len(res["cold"])
            assert res["warm_stats"]["cache_hit_rate"] == 1.0
            for r, a, b in zip(optserve_client.build_requests(),
                               res["cold"], res["warm"]):
                if r.kind == "eval":
                    same = all(np.array_equal(a[k], b[k]) for k in a)
                elif r.kind == "solve":
                    same = (a.objective, a.evaluations) == (b.objective,
                                                            b.evaluations)
                else:
                    same = (a.sequential, a.pipelined) == (b.sequential,
                                                           b.pipelined)
                assert same, (r.kind, a, b)
            assert counts.get("netsim_waterfill", 0) > 0, counts
    return total


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    card = phase_device()
    phase_build()
    rows = {"flash_attention": phase_kernels(), "wkv6": phase_wkv6(),
            "ssm_scan": phase_ssd(), "gemm": phase_gemm()}
    launches = collections.Counter()
    for phase in (phase_calibrate_plan, phase_serve, phase_serve_rwkv6,
                  phase_serve_zamba2, *(
                      functools.partial(phase_serve_zoo, arch)
                      for arch in ZOO_SERVED), phase_encoder_zoo,
                  phase_optimize):
        launches.update(phase())
    counts, rows["sgs_batch"] = phase_sweeps()
    launches.update(counts)
    counts, rows["netsim_waterfill"] = phase_flow()
    launches.update(counts)
    counts, _ = phase_multitenant()
    launches.update(counts)
    launches.update(phase_cosearch())
    launches.update(phase_train())
    launches.update(phase_mesh())
    launches.update(phase_entry_points())
    log("entry", f"launches over the calibration pass, the serve "
        f"paths, the encoder, the pipelining sweep, the flow legs, phase 9, "
        f"phase 10, the trainer, phase 12 and phase 13: {dict(launches)}")
    kernels = [{
        "name": name, "route": "cuda", "source": src, "replaces": tpu,
        "launches": launches[name],
        "max_abs_err": rows[name]["max_abs_err"],
        "ms": rows[name]["kernel_ms"],
        "burst_ms": rows[name]["kernel_burst_ms"],
        "plain_ms": rows[name]["plain_ms"],
        "bound_ms": rows[name]["bound_ms"],
        "bound_by": rows[name]["bound_by"],
        "library_ms": rows[name]["library_ms"]}
        for name, src, tpu in (("flash_attention", FLASH_SRC, FLASH_TPU),
                               ("wkv6", WKV6_SRC, WKV6_TPU),
                               ("ssm_scan", SSD_SRC, SSD_TPU),
                               ("gemm", GEMM_SRC, GEMM_TPU),
                               ("sgs_batch", SGS_SRC, SGS_REPLACES),
                               ("netsim_waterfill", NETSIM_SRC,
                                NETSIM_REPLACES))]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
