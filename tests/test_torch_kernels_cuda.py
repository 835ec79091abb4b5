"""What ``chip_smoke.py`` does not cover of the port's CUDA kernels: each
kernel on strided views, its rejects, one launch per call, and the
build (its key covers the shared headers); the GEMM at the JAX suite's
shapes and the calibration's sizes and the SSD at the calibration's
state dim 16; flash at MLA's latent heads (Dk 288 / Dv 256, KV 1, H 40;
Dk 576 / Dv 512 over two value slices, each slice held on its own) and at
hubert-xlarge's non-causal encoder (D 80) in both dtypes, and its
refusal of pairs it is not built for; its query offset (a slice of
rows at its positions) in both dtypes; the bf16
tensor-core paths of flash (every head-dim tiling, GQA, ragged lengths,
rows that are not 16-byte aligned), of
the GEMM (K tails and unaligned rows), and of the chunked SSD and WKV-6
(every state and head dim, ragged lengths, initial states, strided
views, vanishing decays, a head dim over two column tiles); the batched
SGS of the pipeliner, bit for bit against its plain version (random and
tied durations, one job, one sample, batches over a warp); the batched
waterfilling netsim against its plain version and the numpy engine
(Fig. 3's cells, random meshes up to 16x16, zero and single flows, a
stall, route structures shared or per network, the evaluator's flow
mode); multi-tenant contention in one waterfilling launch bit for bit
the numpy engine, sweeps sharded over the card listed up to three
times, the optimisation server's worker launching kernels, and kernel
libraries loaded from two threads; the flash, WKV-6 and SSD
``autograd.Function``s at their serve shapes in both dtypes (gradients
equal to autograd of the plain version, an unused final state), and
the raw wrappers refusing inputs that require grad; flash, WKV-6 and
SSD called on DTensors over the card as a (1, 1) NCCL mesh (their
``local_map`` region), bit for bit the call on plain tensors, one launch
each. (Every
kernel against its plain version at every variant, in both dtypes, is also
``chip_smoke.py``'s kernel phase.) The ``cuda``-marked tests
need an NVIDIA Hopper card and nvcc and skip elsewhere. Imports no JAX,
so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import itertools

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.blockwise import blockwise_attention
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.gemm.kernel import matmul
from repro_torch.kernels.gemm.ref import matmul_ref
from repro_torch.kernels.netsim import ops as netsim_ops
from repro_torch.kernels.netsim.kernel import waterfill
from repro_torch.kernels.netsim.ref import waterfill_ref
from repro_torch.kernels.rwkv6.chunked import wkv6_chunked
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6.kernel import wkv6
from repro_torch.kernels.sgs.kernel import sgs_batch
from repro_torch.kernels.sgs.ref import sgs_batch_ref
from repro_torch.kernels.ssm_scan.chunked import ssm_scan_chunked
from repro_torch.kernels.ssm_scan import ops as ssd_ops
from repro_torch.kernels.ssm_scan.kernel import ssm_scan

F32_TOL = dict(rtol=3e-5, atol=1.2e-4)
WKV_F32_TOL = dict(rtol=2e-3, atol=2e-3)   # the JAX suite's WKV limit
SSD_F32_TOL = dict(rtol=2e-3, atol=2e-3)   # the JAX suite's SSD limit
# The JAX suite's bf16 SSD and WKV limits (chip_smoke.py's SSD_TOL and
# WKV_TOL in bf16).
SSD_BF16_TOL = dict(rtol=6e-2, atol=6e-2)
WKV_BF16_TOL = dict(rtol=6e-2, atol=6e-2)
# The chunked bf16 SSD (chunks of 64): every state dim (8 padded to 16),
# one step and a ragged length from a nonzero state, two groups, P = 72
# over two 64-column tiles, and dt·|a| up to ~100 (vanishing decays):
# (B, S, H, P, G, N), scale of dt.
SSD_BF16_CASES = {
    **{f"n{n}_s{S}": ((2, S, 4, 16 if n < 64 else 64, 2, n), 1.0)
       for n in (8, 16, 64) for S in (1, 77)},
    "n64_p72_s130": ((1, 130, 2, 72, 1, 64), 1.0),
    "n64_decay0_s70": ((2, 70, 4, 64, 1, 64), 40.0),
}
# The chunked bf16 WKV-6 (chunks of 32): every head dim, one step and a
# ragged length from a nonzero state, and a quarter of the decays at 0
# (clamped to 1e-38, a subnormal): (B, S, H, K), share of decays at 0.
WKV_BF16_CASES = {
    **{f"k{k}_s{S}": ((2, S, 3, k), 0.0) for k in (16, 32, 64)
       for S in (1, 77)},
    "k64_decay0_s70": ((2, 70, 3, 64), 0.25),
}
# The JAX suite's GEMM limits (tests/test_kernels.py: rtol, atol = 8·rtol).
GEMM_TOL = {torch.float32: dict(rtol=2e-5, atol=1.6e-4),
            torch.bfloat16: dict(rtol=3e-2, atol=0.24)}
# The JAX suite's shapes, then the calibration pass's (smoke and full).
GEMM_SHAPES = [(128, 128, 128), (256, 512, 128), (100, 70, 130),
               (33, 257, 65), (256, 256, 256), (512, 512, 512),
               (768, 768, 768)]
# The JAX suite's bf16 flash limit (chip_smoke.py's TOL[bfloat16]).
FLASH_BF16_TOL = dict(rtol=2e-2, atol=8e-2)
# The bf16 tensor-core flash path at every head-dim tiling it has (Q in
# registers with 64-key tiles up to D 160, with 32-key tiles at 176-192,
# Q in shared memory above), GQA 3:1, Sq and Skv that are not multiples
# of 16 or 64, and (b, h) pairs at zamba2's head dim and length that the
# kernel runs in more than one group whose K and V fit in L2 (128 pairs in
# 4 groups of 32; 39 in groups of 20 and 19): (B, Sq, Skv, H, KV, Dk,
# Dv), kwargs.
FLASH_BF16_CASES = {
    **{f"d{d}": ((1, 130, 130, 3, 1, d, d), dict(causal=True))
       for d in (16, 32, 64, 80, 128, 160, 192, 208, 256)},
    "b8_h16_s1024_d160": ((8, 1024, 1024, 16, 16, 160, 160),
                          dict(causal=True)),
    "b3_h13_s1024_d160": ((3, 1024, 1024, 13, 13, 160, 160),
                          dict(causal=True)),
    "dk80_dv64": ((2, 96, 96, 8, 1, 80, 64), dict(causal=True, scale=0.125)),
    "gqa3_cross_100x150": ((2, 100, 150, 6, 2, 64, 64), dict(causal=False)),
    "gqa3_causal_77x77": ((2, 77, 77, 6, 2, 32, 32), dict(causal=True)),
    "window50_softcap30": ((1, 300, 300, 6, 2, 64, 64),
                           dict(causal=True, window=50, softcap=30.0)),
    "d160_window70_softcap50": ((1, 200, 200, 2, 2, 160, 160),
                                dict(causal=True, window=70, softcap=50.0)),
}
# bf16 GEMMs whose K or N rows are not 16-byte aligned (and K tails):
# every order of 33, 257 and 65, then A aligned with B not, and the
# reverse. (M, K, N).
GEMM_BF16_RAGGED = [*itertools.permutations((33, 257, 65)),
                    (33, 256, 65), (257, 65, 256)]


# The batched SGS: (G, batch, n_ops), durations rounded to integers
# (ties among priorities) or not, share of zero durations.
SGS_CASES = {
    "one_job": ((1, 1, 1), False, 0.0),
    "one_sample": ((3, 1, 5), False, 0.3),
    "vit_b16": ((4, 16, 74), False, 0.0),
    "ties": ((5, 6, 4), True, 0.3),
    "all_tied": ((2, 8, 3), True, 1.0),
    "batch_over_a_warp": ((2, 45, 6), False, 0.2),
    "batch_two_warps_ties": ((3, 64, 2), True, 0.3),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_flash_kernel_reads_strided_views(cuda):
    """q/k/v as views into one fused projection (non-contiguous heads);
    one launch per call."""
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(2, 70, 4 + 2 + 2, 32, generator=g, device=cuda)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True)
    assert flash_attention.launches == before + 1
    want = blockwise_attention(q, k, v, causal=True)
    torch.testing.assert_close(got, want, **F32_TOL)


@pytest.mark.cuda
def test_flash_kernel_rejects_bad_inputs(cuda):
    q = torch.zeros(1, 8, 4, 32, device=cuda)
    k = torch.zeros(1, 8, 3, 32, device=cuda)
    with pytest.raises(ValueError, match="H % KV"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="contiguous"):
        qt = q.transpose(-1, -2)
        flash_attention(qt, qt, qt)


@pytest.mark.cuda
def test_wkv6_kernel_reads_strided_views(cuda):
    """r/k/v/w as head views of one fused (B, S, 4·H·K) projection, from
    a nonzero state; y and the final state; one launch per call."""
    B, S, H, K = 2, 70, 3, 64
    g = torch.Generator(device=cuda).manual_seed(2)
    proj = torch.randn(B, S, 4 * H * K, generator=g, device=cuda)
    r, k, v, w = (t.unflatten(-1, (H, K)) for t in proj.chunk(4, dim=-1))
    w = torch.exp(-torch.exp(0.5 * w))
    u = 0.3 * torch.randn(H, K, generator=g, device=cuda)
    s0 = 0.3 * torch.randn(B, H, K, K, generator=g, device=cuda)
    assert not r.is_contiguous()
    before = wkv6.launches
    y, sT = wkv6(r, k, v, w, u, s0=s0)
    assert wkv6.launches == before + 1
    want_y, want_s = wkv6_chunked(r, k, v, w, u, s0=s0, chunk=32)
    torch.testing.assert_close(y, want_y, **WKV_F32_TOL)
    torch.testing.assert_close(sT, want_s, **WKV_F32_TOL)


@pytest.mark.cuda
def test_wkv6_kernel_rejects_bad_inputs(cuda):
    r = torch.zeros(1, 8, 2, 16, device=cuda)
    u = torch.zeros(2, 16, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        wkv6(r, r.bfloat16(), r, r, u)
    r24 = torch.zeros(1, 8, 2, 24, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        wkv6(r24, r24, r24, r24, torch.zeros(2, 24, device=cuda))
    with pytest.raises(ValueError, match="s0"):
        wkv6(r, r, r, r, u, s0=torch.zeros(1, 2, 16, 16, device=cuda,
                                           dtype=torch.bfloat16))
    odd = torch.zeros(1, 8, 2, 17, device=cuda)[..., 1:]
    with pytest.raises(ValueError, match="aligned"):
        wkv6(odd, r, r, r, u)


@pytest.mark.cuda
def test_flash_kernel_head_dim_160_with_window(cuda):
    """zamba2's shared attention: Dk = Dv = 160 (five value columns a
    lane, ~100 KB of shared memory) and a window shorter than S."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(1, 300, 4, 160, generator=g, device=cuda)
               for _ in range(3))
    got = flash_attention(q, k, v, causal=True, window=100)
    want = blockwise_attention(q, k, v, causal=True, window=100)
    torch.testing.assert_close(got, want, **F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_BF16_CASES)
def test_flash_kernel_bf16_matches_plain(cuda, case):
    """The tensor-core path against the plain version on the same bf16
    inputs; one launch per call."""
    (B, Sq, Skv, H, KV, dk, dv), kw = FLASH_BF16_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(*s, generator=g, device=cuda).bfloat16()
               for s in ((B, Sq, H, dk), (B, Skv, KV, dk), (B, Skv, KV, dv)))
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (B, Sq, H, dv)
    want = blockwise_attention(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_BF16_TOL)


# The query offset: a slice of rows of a longer query at its positions
# (one rank's rows of a query chunk), against the plain version at that
# offset; offsets that start inside, at and past a 64-row tile, windowed,
# soft-capped, and MLA's latent head.
FLASH_OFFSET_CASES = {
    "d64_o40": ((2, 96, 320, 6, 2, 64, 64), 40, dict(causal=True)),
    "d64_o128_win": ((2, 64, 320, 6, 2, 64, 64), 128,
                     dict(causal=True, window=90)),
    "d80_o200_cap": ((1, 120, 320, 4, 4, 80, 80), 200,
                     dict(causal=True, softcap=30.0)),
    "mla_o96": ((1, 64, 256, 40, 1, 288, 256), 96,
                dict(causal=True, scale=96 ** -0.5)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_OFFSET_CASES)
def test_flash_kernel_query_offset(cuda, case, dtype):
    """The kernel with ``q_offset`` against the plain version at the same
    offset, one launch a call; offset 0 is the call without it, bit for
    bit."""
    (B, Sq, Skv, H, KV, dk, dv), off, kw = FLASH_OFFSET_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (torch.randn(*s, generator=g, device=cuda).to(dtype)
               for s in ((B, Sq, H, dk), (B, Skv, KV, dk), (B, Skv, KV, dv)))
    before = flash_attention.launches
    got = flash_attention(q, k, v, q_offset=off, **kw)
    assert flash_attention.launches == before + 1
    want = blockwise_attention(q, k, v, q_offset=off, **kw)
    tol = F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(flash_attention(q, k, v, q_offset=0, **kw),
                       flash_attention(q, k, v, **kw))
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q, k, v, q_offset=-1, **kw)


# MLA's absorbed latent head (minicpm3-4b): MQA (KV 1) with H 40, keys of
# kv_lora 256 + rope 32, values of kv_lora 256, scale 1/sqrt(nope + rope)
# = 1/sqrt(96), causal; the value a view of the key's first 256 columns
# as the MLA layer passes it, or a tensor of its own; a ragged length.
MLA_CASES = {"view_s200": (200, True), "own_v_s77": (77, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", MLA_CASES)
def test_flash_kernel_mla_latent_head(cuda, case, dtype):
    S, view = MLA_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(2, S, 40, 288, generator=g, device=cuda).to(dtype)
    k = torch.randn(2, S, 1, 288, generator=g, device=cuda).to(dtype)
    v = k[..., :256] if view else torch.randn(
        2, S, 1, 256, generator=g, device=cuda).to(dtype)
    kw = dict(causal=True, scale=96 ** -0.5)
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == before + 1
    assert got.shape == (2, S, 40, 256) and got.dtype == dtype
    want = blockwise_attention(q, k, v, **kw)
    tol = F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)


# deepseek-v2's latent head: keys of kv_lora 512 + rope 64, values of
# kv_lora 512 (two slices of 256, each a block of its own), scale
# 1/sqrt(nope + rope) = 1/sqrt(192), causal, KV 1; the value a view of the
# key's first 512 columns as the MLA layer passes it, or its own tensor.
DEEPSEEK_CASES = {"view_s96": (96, True), "own_v_s130": (130, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", DEEPSEEK_CASES)
def test_flash_kernel_deepseek_latent_head(cuda, case, dtype):
    S, view = DEEPSEEK_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(8)
    q = torch.randn(2, S, 8, 576, generator=g, device=cuda).to(dtype)
    k = torch.randn(2, S, 1, 576, generator=g, device=cuda).to(dtype)
    v = k[..., :512] if view else torch.randn(
        2, S, 1, 512, generator=g, device=cuda).to(dtype)
    kw = dict(causal=True, scale=192 ** -0.5)
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == before + 1
    assert got.shape == (2, S, 8, 512) and got.dtype == dtype
    want = blockwise_attention(q, k, v, **kw)
    tol = F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
    for lo in (0, 256):     # each value slice on its own
        torch.testing.assert_close(got[..., lo:lo + 256].float(),
                                   want[..., lo:lo + 256].float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernel_encoder_head_dim_80(cuda, dtype):
    """hubert-xlarge's attention: not causal, H = KV, D 80, a ragged
    S of 150 (the last 64-key tile holds 22)."""
    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn(2, 150, 4, 80, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    got = flash_attention(q, k, v, causal=False)
    want = blockwise_attention(q, k, v, causal=False)
    tol = F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
def test_flash_kernel_rejects_unbuilt_head_dims(cuda):
    """Only Dk, Dv <= 256 and the pairs rounding up to (288, 256) and
    (576, 512) are built: any other pair raises before a launch."""
    before = flash_attention.launches
    for dk, dv in ((300, 256), (288, 240), (256, 288), (576, 480),
                   (600, 512), (512, 576)):
        q = torch.zeros(1, 8, 2, dk, device=cuda)
        v = torch.zeros(1, 8, 1, dv, device=cuda)
        with pytest.raises(ValueError, match="head dims"):
            flash_attention(q, q[:, :, :1], v)
    assert flash_attention.launches == before


@pytest.mark.cuda
def test_flash_kernel_bf16_reads_unaligned_rows(cuda):
    """bf16 q, k, v as views of a fused projection whose row stride (an
    odd number of elements) is not 16-byte aligned: the kernel's
    element-by-element loads."""
    B, S, H, KV, D = 2, 90, 6, 2, 64
    g = torch.Generator(device=cuda).manual_seed(6)
    qkv = torch.randn(B, S, (H + 2 * KV) * D + 1, generator=g,
                      device=cuda).bfloat16()
    q, k, v = (t.unflatten(-1, (-1, D)) for t in torch.split(
        qkv[..., :-1], [H * D, KV * D, KV * D], dim=-1))
    assert q.stride(1) % 8 != 0
    got = flash_attention(q, k, v, causal=True)
    want = blockwise_attention(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_BF16_TOL)


def _conv_output(cuda, B, S, H, P, G, N, dtype=torch.float32, seed=4,
                 dt_scale=1.0):
    """x, B, C as the Mamba-2 layer gives them: views of one (B, S,
    H·P + 2·G·N) convolution output split along its last dim."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    xbc = torch.randn(B, S, H * P + 2 * G * N, generator=g,
                      device=cuda).to(dtype)
    x, bm, cm = torch.split(xbc, [H * P, G * N, G * N], dim=-1)
    dt = dt_scale * torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=g, device=cuda))
    a = -torch.exp(0.5 * torch.randn(H, generator=g, device=cuda))
    d = 0.1 * torch.randn(H, generator=g, device=cuda)
    h0 = 0.3 * torch.randn(B, H, P, N, generator=g, device=cuda)
    return (x.unflatten(-1, (H, P)), dt, a, bm.unflatten(-1, (G, N)),
            cm.unflatten(-1, (G, N)), d), h0


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2])
def test_ssm_scan_kernel_reads_strided_views(cuda, G):
    """x, B and C as views of a split convolution output (row stride
    H·P + 2·G·N), B and C read by group, from a nonzero state; y and the
    final state; one launch per call."""
    args, h0 = _conv_output(cuda, 2, 100, 4, 64, G, 64)
    assert not args[0].is_contiguous() and not args[3].is_contiguous()
    before = ssm_scan.launches
    y, hT = ssm_scan(*args, h0=h0)
    assert ssm_scan.launches == before + 1
    want_y, want_h = ssm_scan_chunked(*args, h0=h0, chunk=32)
    torch.testing.assert_close(y, want_y, **SSD_F32_TOL)
    torch.testing.assert_close(hT, want_h, **SSD_F32_TOL)


@pytest.mark.cuda
def test_ssm_scan_kernel_rejects_bad_inputs(cuda):
    (x, dt, a, bm, cm, d), h0 = _conv_output(cuda, 1, 8, 2, 16, 1, 8)
    with pytest.raises(ValueError, match="dtype"):
        ssm_scan(x, dt, a, bm.bfloat16(), cm, d)
    with pytest.raises(ValueError, match="dt must be float32"):
        ssm_scan(x, dt.bfloat16(), a, bm, cm, d)
    with pytest.raises(ValueError, match="h0"):
        ssm_scan(x, dt, a, bm, cm, d, h0=h0.bfloat16())
    with pytest.raises(ValueError, match="state dim"):
        ssm_scan(x, dt, a, bm[..., :4], cm[..., :4], d)
    with pytest.raises(ValueError, match="divide"):
        ssm_scan(x, dt, a, torch.cat([bm] * 3, 2), torch.cat([cm] * 3, 2),
                 d)
    odd = torch.zeros(1, 8, 2, 17, device=cuda)[..., 1:]
    with pytest.raises(ValueError, match="aligned"):
        ssm_scan(odd, dt, a, bm, cm, d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_kernel_state_dim_16(cuda, dtype):
    """The calibration's full SSD samples: N = 16, P = 16, one group, as
    strided views, from a nonzero state."""
    args, h0 = _conv_output(cuda, 2, 512, 2, 16, 1, 16, dtype=dtype)
    y, hT = ssm_scan(*args, h0=h0)
    want_y, want_h = ssm_scan_chunked(*args, h0=h0, chunk=64)
    tol = 2e-3 if dtype == torch.float32 else 6e-2
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(hT, want_h, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_BF16_CASES)
def test_ssm_scan_kernel_bf16_matches_plain(cuda, case):
    """The chunked tensor-core path on strided views of a convolution
    output, from a nonzero state, against the plain version; one launch
    per call."""
    shape, dt_scale = SSD_BF16_CASES[case]
    args, h0 = _conv_output(cuda, *shape, dtype=torch.bfloat16,
                            dt_scale=dt_scale)
    assert not args[0].is_contiguous()
    before = ssm_scan.launches
    y, hT = ssm_scan(*args, h0=h0)
    assert ssm_scan.launches == before + 1
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()
    want_y, want_h = ssm_scan_chunked(*args, h0=h0, chunk=64)
    torch.testing.assert_close(y.float(), want_y.float(), **SSD_BF16_TOL)
    torch.testing.assert_close(hT, want_h, **SSD_BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", WKV_BF16_CASES)
def test_wkv6_kernel_bf16_matches_plain(cuda, case):
    """The chunked tensor-core path on head views of one fused bf16
    projection, from a nonzero state, against the plain version; one
    launch per call."""
    (B, S, H, K), zeros = WKV_BF16_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(7)
    proj = torch.randn(B, S, 4 * H * K, generator=g, device=cuda)
    r, k, v, x = (t.unflatten(-1, (H, K)) for t in proj.chunk(4, dim=-1))
    w = torch.exp(-torch.exp(0.5 * x))
    if zeros:
        w = torch.where(torch.rand(w.shape, generator=g, device=cuda)
                        < zeros, 0.0, w)
    fused = torch.cat([r, k, v, w], dim=-1).bfloat16()   # (B, S, H, 4K)
    r, k, v, w = fused.split(K, dim=-1)
    u = 0.3 * torch.randn(H, K, generator=g, device=cuda)
    s0 = 0.3 * torch.randn(B, H, K, K, generator=g, device=cuda)
    assert not r.is_contiguous()
    before = wkv6.launches
    y, sT = wkv6(r, k, v, w, u, s0=s0)
    assert wkv6.launches == before + 1
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()
    want_y, want_s = wkv6_chunked(r, k, v, w, u, s0=s0, chunk=32)
    torch.testing.assert_close(y.float(), want_y.float(), **WKV_BF16_TOL)
    torch.testing.assert_close(sT, want_s, **WKV_BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
def test_gemm_kernel_matches_plain(cuda, m, k, n, dtype):
    """Ragged M, N and K included (100×70×130, 33×257×65); one launch per
    call; C in the inputs' dtype."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    a = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    b = torch.randn(k, n, generator=g, device=cuda).to(dtype)
    before = matmul.launches
    got = matmul(a, b)
    assert matmul.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (m, n)
    torch.testing.assert_close(got.float(), matmul_ref(a, b).float(),
                               **GEMM_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", GEMM_BF16_RAGGED)
def test_gemm_kernel_bf16_unaligned_rows(cuda, m, k, n):
    """bf16 rows that are not 16-byte aligned take the kernel's
    element-by-element staging; K tails, ragged M and N."""
    g = torch.Generator(device=cuda).manual_seed(m * k + n)
    a = torch.randn(m, k, generator=g, device=cuda).bfloat16()
    b = torch.randn(k, n, generator=g, device=cuda).bfloat16()
    got = matmul(a, b)
    torch.testing.assert_close(got.float(), matmul_ref(a, b).float(),
                               **GEMM_TOL[torch.bfloat16])


@pytest.mark.cuda
def test_gemm_kernel_rejects_bad_inputs(cuda):
    a = torch.zeros(8, 16, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        matmul(a, a.T.contiguous().bfloat16())
    with pytest.raises(ValueError, match="dtype"):
        matmul(a.half(), a.T.contiguous().half())
    with pytest.raises(ValueError, match="contiguous"):
        matmul(a, a.T)                    # a strided (16, 8) view
    with pytest.raises(ValueError, match="inner dims"):
        matmul(a, a)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SGS_CASES)
def test_sgs_kernel_matches_plain_bitwise(cuda, case):
    """Makespans and starts bit for bit: only float64 max and + touch
    the times, in the same order (no tolerance)."""
    import numpy as np
    (G, B, n), ties, p_zero = SGS_CASES[case]
    rng = np.random.default_rng(len(case))
    dur = np.where(rng.random((G, 3 * n)) < p_zero, 0.0,
                   rng.uniform(0.0, 5.0, (G, 3 * n)))
    if ties:
        dur = np.round(dur)
    prio = np.cumsum(dur[:, ::-1], axis=1)[:, ::-1].copy()
    d = torch.from_numpy(dur).to(cuda)
    p = torch.from_numpy(prio).to(cuda)
    before = sgs_batch.launches
    ms, st = sgs_batch(d, p, B)
    assert sgs_batch.launches == before + 1
    torch.cuda.synchronize()
    ms_ref, st_ref = sgs_batch_ref(d, p, B)
    assert torch.equal(ms, ms_ref)
    assert torch.equal(st, st_ref)


@pytest.mark.cuda
def test_sgs_kernel_rejects_bad_inputs(cuda):
    d = torch.ones(2, 6, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="float64"):
        sgs_batch(d.float(), d.float(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        sgs_batch(d.T, d.T, 2)
    with pytest.raises(ValueError, match="differ"):
        sgs_batch(d, d[:1], 2)
    with pytest.raises(ValueError, match="batch"):
        sgs_batch(d, d, 0)
    with pytest.raises(ValueError, match="shared memory"):
        sgs_batch(d, d, 20000)


def test_sgs_kernel_rejects_cpu_tensors():
    """The kernel never takes CPU tensors (``ops.sgs_batch`` sends those
    to the plain version); the check comes before any build or launch."""
    d = torch.ones(1, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        sgs_batch(d, d, 2)


GB = 1e9
# Random meshes (X, Y, attach count, seed) for the waterfilling kernel:
# pull flows from random attach sets with random per-chiplet demand.
NETSIM_MESHES = {"1x1": (1, 1, 1, 0), "2x3": (2, 3, 2, 1),
                 "4x4": (4, 4, 3, 2), "8x8": (8, 8, 4, 3),
                 "5x12": (5, 12, 2, 4), "16x16": (16, 16, 1, 5)}


def _netsim_case(X, Y, k, seed):
    import numpy as np
    from repro_torch.core.netsim import MeshNet
    rng = np.random.default_rng(seed)
    attach = sorted(rng.choice(X * Y, size=k, replace=False).tolist())
    net = MeshNet(X, Y, float(rng.uniform(20, 200)) * GB,
                  float(rng.uniform(20, 2000)) * GB, attach)
    return net, rng.uniform(0.01, 1.0, X * Y) * GB


def _netsim_both(cuda, cap, inc, msgs):
    """The kernel (one launch) and its plain version on the card, on
    ``cap [N, L]``, ``inc [N, F, L]``, ``msgs [N, S, F]`` numpy arrays."""
    import numpy as np
    c, i, m = (torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
               for a in (cap, inc, msgs))
    routes = torch.from_numpy(netsim_ops.route_lists(inc)).to(cuda)
    before = waterfill.launches
    got = waterfill(c, routes, m)
    assert waterfill.launches == before + 1
    torch.cuda.synchronize()
    return got, waterfill_ref(c, i, m)


def _netsim_equal(got, ref):
    """latency, done and rounds bit for bit; link_bytes summed in
    another order (rtol 1e-9, atol 1e-3 bytes)."""
    lat, done, lb, rounds = got
    for a, b in ((lat, ref[0]), (done, ref[1])):   # NaN where both stall
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(rounds, ref[3])
    torch.testing.assert_close(lb, ref[2], rtol=1e-9, atol=1e-3,
                               equal_nan=True)


@pytest.mark.cuda
def test_netsim_kernel_fig3_cells(cuda):
    """Fig. 3's eight cells in one launch: bit for bit against the plain
    version and the numpy engine."""
    import numpy as np
    from repro_torch.core.netsim import fig3_net, simulate_flows
    nets = [fig3_net(m, p, bw * GB) for m in ("dram", "hbm")
            for p in ("peripheral", "central") for bw in (60, 120)]
    cap = np.stack([n.link_caps() for n in nets])
    inc = np.stack([n.pull_incidence() for n in nets])
    msgs = np.full((len(nets), 1, 16), GB)
    got, ref = _netsim_both(cuda, cap, inc, msgs)
    _netsim_equal(got, ref)
    for g, n in enumerate(nets):
        want = simulate_flows(inc[g], cap[g], msgs[g, 0])
        assert float(got[0][g, 0]) == want["latency"]
        assert np.array_equal(got[1][g, 0].cpu().numpy(), want["done"])


@pytest.mark.cuda
@pytest.mark.parametrize("case", NETSIM_MESHES)
def test_netsim_kernel_random_meshes(cuda, case):
    import numpy as np
    from repro_torch.core.netsim import simulate_flows
    net, msgs = _netsim_case(*NETSIM_MESHES[case])
    cap, inc = net.link_caps(), net.pull_incidence()
    got, ref = _netsim_both(cuda, cap[None], inc[None], msgs[None, None])
    _netsim_equal(got, ref)
    want = simulate_flows(inc, cap, msgs)
    assert float(got[0][0, 0]) == want["latency"]
    assert np.array_equal(got[1][0, 0].cpu().numpy(), want["done"])


@pytest.mark.cuda
def test_netsim_kernel_flow_net_16x16_random_demand(cuda):
    """The evaluator's network at the paper's largest mesh (type A, mesh
    routes only) with random per-chiplet demand, some chiplets idle."""
    import numpy as np
    from repro_torch.core.hw import make_hw
    cap, dinc, cinc = make_hw("A", 16, "hbm").topology.flow_net()
    rng = np.random.default_rng(7)
    msgs = rng.uniform(0.0, 1.0, (2, 3, 256)) * 1e6
    msgs[:, :, rng.random(256) < 0.2] = 0.0
    routed = np.stack([dinc, cinc]).sum(-1) > 0
    msgs *= routed[:, None, :]
    got, ref = _netsim_both(cuda, np.stack([cap, cap]),
                            np.stack([dinc, cinc]), msgs)
    _netsim_equal(got, ref)
    assert int(got[3].max()) > 10


@pytest.mark.cuda
def test_netsim_kernel_zero_single_and_stalled_flows(cuda):
    """All-zero demand ends at 0 with no round; one flow runs at its
    route's least capacity; a dead port stalls its simulation (NaN in
    every float output) and leaves the others in the launch alone."""
    import numpy as np
    net, msgs = _netsim_case(4, 4, 2, 8)
    cap, inc = net.link_caps(), net.pull_incidence()
    dead = cap.copy()
    dead[net.graph.index[(net.mem, net.attach[0])]] = 0.0
    single = np.zeros(16)
    single[15] = GB
    caps = np.stack([cap, cap, cap, dead])
    got, ref = _netsim_both(cuda, caps, np.stack([inc] * 4),
                            np.stack([msgs, np.zeros(16), single, msgs]
                                     )[:, None])
    _netsim_equal(got, ref)
    lat, done, lb, rounds = (t[:, 0].cpu() for t in got)
    assert float(lat[1]) == 0.0 and int(rounds[1]) == 0
    assert not done[1].any() and not lb[1].any()
    assert float(lat[2]) == pytest.approx(GB / cap[inc[15] > 0].min(),
                                          rel=1e-12)
    assert torch.isnan(lat[3]) and torch.isnan(done[3]).all()
    assert torch.isnan(lb[3]).all()
    assert torch.isfinite(lat[:3]).all()


@pytest.mark.cuda
def test_netsim_kernel_shared_and_per_cell_routes(cuda):
    """One network shared by S simulations (the evaluator's layout)
    equals S copies of it, one simulation each (netsim_sweep's)."""
    import numpy as np
    net, _ = _netsim_case(8, 8, 3, 9)
    cap, inc = net.link_caps(), net.pull_incidence()
    msgs = np.random.default_rng(9).uniform(0.01, 1.0, (5, 64)) * GB
    shared, _ = _netsim_both(cuda, cap[None], inc[None], msgs[None])
    per, _ = _netsim_both(cuda, np.stack([cap] * 5), np.stack([inc] * 5),
                          msgs[:, None])
    assert torch.equal(shared[0][0], per[0][:, 0])
    assert torch.equal(shared[1][0], per[1][:, 0])
    lb = shared[2]
    none = waterfill(*(torch.from_numpy(a).to(cuda) for a in (
        cap[None], netsim_ops.route_lists(inc[None]), msgs[None])),
        link_bytes=False)
    assert none[2] is None and torch.equal(none[0], shared[0])
    assert lb.shape == (1, 5, cap.size)


@pytest.mark.cuda
def test_netsim_kernel_rejects_bad_inputs(cuda):
    cap = torch.ones(1, 8, dtype=torch.float64, device=cuda)
    routes = torch.zeros(1, 4, 2, dtype=torch.int32, device=cuda)
    msgs = torch.ones(1, 3, 4, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="float64"):
        waterfill(cap.float(), routes, msgs)
    with pytest.raises(ValueError, match="int32"):
        waterfill(cap, routes.long(), msgs)
    with pytest.raises(ValueError, match="disagree"):
        waterfill(cap, routes, msgs[..., :3].contiguous())
    big = torch.zeros(1, 1025, 2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="1024"):
        waterfill(cap, big, torch.ones(1, 1, 1025, dtype=torch.float64,
                                       device=cuda))
    wide = torch.zeros(1, 1024, 64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        waterfill(cap, wide, torch.ones(1, 1, 1024, dtype=torch.float64,
                                        device=cuda))


def test_netsim_kernel_rejects_cpu_tensors():
    """The kernel never takes CPU tensors (``ops.waterfill`` sends those
    to the plain version); the check comes before any build or launch."""
    cap = torch.ones(1, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        waterfill(cap, torch.zeros(1, 2, 1, dtype=torch.int32),
                  torch.ones(1, 1, 2, dtype=torch.float64))


@pytest.mark.cuda
def test_netsim_evaluator_flow_mode_on_the_card(cuda):
    """The torch evaluator in flow mode on the card: one launch a call
    and the numpy evaluator's numbers at rtol 1e-9."""
    import numpy as np
    from repro_torch.core import EvalOptions, Evaluator, make_hw
    from repro_torch.core.workload import uniform_partition
    from repro_torch.graphs import WORKLOADS
    task = WORKLOADS["alexnet"](batch=1)
    for t in "ABCD":
        hw = make_hw(t, 4, "hbm")
        opts = EvalOptions(redistribution=True, async_exec=True,
                           congestion="flow")
        part = uniform_partition(task, 4, 4)
        before = waterfill.launches
        got = Evaluator(task, hw, opts, backend="torch",
                        device=cuda).evaluate(part)
        assert waterfill.launches == before + 1
        want = Evaluator(task, hw, opts).evaluate(part)
        assert got.latency == pytest.approx(want.latency, rel=1e-9)
        np.testing.assert_allclose(got.t_in, want.t_in, rtol=1e-9)
        np.testing.assert_allclose(got.t_out, want.t_out, rtol=1e-9)


def _tenant_tasks(T):
    from repro_torch.core.workload import GemmOp, Task
    out = []
    for i in range(T):
        ops = [GemmOp("g0", M=256 * (i + 1), K=256, N=512)]
        for j in range(1, 2 + i % 2):
            ops.append(GemmOp(f"g{j}", M=256 * (i + 1), K=512, N=512,
                              chained=True))
        out.append(Task(f"t{i}", ops))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("typ,grid,T,cap", [("A", 4, 2, 64),
                                            ("A", 8, 3, 16),
                                            ("B", 8, 4, 12),
                                            ("A", 16, 4, 64)])
def test_multitenant_contention_one_launch_bitwise_numpy(cuda, typ, grid,
                                                         T, cap):
    """Every band assignment's contention in one waterfilling launch on
    the card, slowdowns bit for bit the numpy engine's per-assignment
    loop; flows outside a tenant's band (0 bytes) end at done = 0."""
    import numpy as np
    from repro_torch.core import make_hw
    from repro_torch.core import multitenant as mt
    hw = make_hw(typ, grid, "hbm")
    tasks = _tenant_tasks(T)
    asg = mt.band_assignments(grid, T, cap)
    outs = []
    real = netsim_ops.waterfill

    def spy(caps, inc, msgs, routes=None, link_bytes=True):
        out = real(caps, inc, msgs, routes=routes, link_bytes=link_bytes)
        outs.append((msgs, out[1]))
        return out

    netsim_ops.waterfill = spy
    before = waterfill.launches
    try:
        got = mt._contention_slowdowns_batch(tasks, asg, hw, device=cuda)
    finally:
        netsim_ops.waterfill = real
    assert waterfill.launches == before + 1 and len(outs) == 1
    want = np.stack([mt._contention_slowdowns(tasks, a, hw) for a in asg])
    np.testing.assert_array_equal(got, want)
    msgs, done = outs[0]
    assert bool((done[msgs == 0] == 0).all())


@pytest.mark.cuda
def test_multitenant_solve_on_the_card_matches_numpy(cuda):
    """A multi-tenant solve on the card: one waterfilling launch, the
    numpy backend's assignment and slowdowns, scores at rtol 1e-9."""
    from repro_torch.core import make_hw
    from repro_torch.core import multitenant as mt
    hw = make_hw("A", 8, "hbm")
    tasks = _tenant_tasks(3)
    cfg = mt.MultiTenantConfig(method="uniform")
    before = waterfill.launches
    got = mt.solve_multitenant(tasks, hw, cfg=cfg, device=cuda)
    assert waterfill.launches == before + 1
    want = mt.solve_multitenant(tasks, hw, cfg=cfg, backend="numpy")
    assert got.assignment == want.assignment
    assert [d["slowdown"] for d in got.per_tenant] == \
        [d["slowdown"] for d in want.per_tenant]
    assert got.edp == pytest.approx(want.edp, rel=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3])
def test_sharded_sweeps_on_the_card_bitwise(cuda, k):
    """devices="sharded" with the card listed k times: eval under flow
    (one launch a shard), netsim_sweep and pipeline_sweep, bit for bit
    the single-device records."""
    import numpy as np
    from repro_torch.core import EvalOptions, make_hw, sweep, sweep_shard
    from repro_torch.core.netsim import MeshNet
    task = _tenant_tasks(3)[2]
    opts = EvalOptions(congestion="flow", redistribution=True)
    pts = [sweep.EvalPoint(task, make_hw("A", 4, "hbm", bw_nop=48.0 + 16 * i),
                           opts) for i in range(5)]
    nets = [MeshNet(4, 4, 64.0 + i, 128.0, [0, 3]) for i in range(5)]
    rng = np.random.default_rng(k)
    ppts = [sweep.PipelinePoint([(f"op{i}", *rng.uniform(0.1, 2.0, 3))
                                 for i in range(6)], 8) for _ in range(5)]
    single = (sweep.eval_sweep(pts, cache=False, device=cuda,
                               devices="single"),
              sweep.netsim_sweep(nets, 1e6, cache=False, device=cuda,
                                 devices="single"),
              sweep.pipeline_sweep(ppts, cache=False, device=cuda,
                                   devices="single"))
    before = waterfill.launches
    with sweep_shard.use_mesh([cuda] * k):
        shard = (sweep.eval_sweep(pts, cache=False, device=cuda,
                                  devices="sharded"),
                 sweep.netsim_sweep(nets, 1e6, cache=False, device=cuda,
                                    devices="sharded"),
                 sweep.pipeline_sweep(ppts, cache=False, device=cuda,
                                      devices="sharded"))
    assert waterfill.launches == before + 2 * k
    for a, b in zip(single[0], shard[0]):
        for key in ("latency", "energy", "t_in", "t_out"):
            np.testing.assert_array_equal(a[key], b[key])
    for a, b in zip(single[1], shard[1]):
        assert a["latency"] == b["latency"]
        np.testing.assert_array_equal(a["done"], b["done"])
    assert [r.pipelined for r in single[2]] == [r.pipelined
                                                for r in shard[2]]


@pytest.mark.cuda
def test_optserver_on_the_card_served_equals_solo(cuda):
    """The server's worker thread launches the kernels: served records
    equal solo sweep calls bit for bit (eval under flow, a pipeline and a
    multi-tenant solve)."""
    import numpy as np
    from repro_torch.core import (EvalOptions, MultiTenantConfig, make_hw,
                                  sweep)
    from repro_torch.serve import OptRequest, OptServer
    tasks = _tenant_tasks(2)
    hw = make_hw("A", 4, "hbm")
    reqs = [OptRequest("eval", sweep.EvalPoint(
                t, hw, EvalOptions(congestion="flow"))) for t in tasks]
    reqs.append(OptRequest("pipeline", sweep.PipelinePoint(
        [("a", 1.0, 2.0, 1.0), ("b", 0.5, 1.0, 0.5)], 4)))
    reqs.append(OptRequest("solve", sweep.MultiTenantPoint(tuple(tasks), hw),
                           objective="edp", method="multitenant",
                           cfg=MultiTenantConfig(method="uniform")))
    solo = [sweep.eval_sweep([r.point], cache=False)[0] for r in reqs[:2]]
    solo.append(sweep.pipeline_sweep([reqs[2].point], cache=False)[0])
    solo.append(sweep.multitenant_sweep([reqs[3].point],
                                        cfg=reqs[3].cfg, cache=False)[0])
    sweep.clear_cache()
    srv = OptServer(autostart=False)
    futs = [srv.submit(r) for r in reqs]
    srv.start()
    got = [f.result(timeout=120) for f in futs]
    srv.kill()
    for a, b in zip(solo[:2], got[:2]):
        np.testing.assert_array_equal(a["t_in"], b["t_in"])
        assert a["latency"] == b["latency"]
    assert solo[2].pipelined == got[2].pipelined
    assert (solo[3].assignment, solo[3].objective) == \
        (got[3].assignment, got[3].objective)


@pytest.mark.cuda
def test_kernel_load_from_two_threads(cuda):
    """Two threads loading a kernel library at once get the same one."""
    import threading
    libs = []
    start = threading.Barrier(2)

    def first_use():
        start.wait(timeout=60)
        libs.append(_build.load("netsim_waterfill"))

    threads = [threading.Thread(target=first_use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert len(libs) == 2 and libs[0] is libs[1]


def test_ssm_scan_kernel_rejects_cpu_tensors():
    """The kernel never takes CPU tensors (``ops.ssm_scan`` sends those to
    the plain version); the check comes before any build or launch."""
    x = torch.zeros(1, 8, 2, 16)
    bm, dt, h = torch.zeros(1, 8, 1, 8), torch.zeros(1, 8, 2), torch.zeros(2)
    with pytest.raises(ValueError, match="CUDA"):
        ssm_scan(x, dt, h, bm, bm, h)


def test_wkv6_kernel_rejects_cpu_tensors():
    """The kernel never takes CPU tensors (``ops.wkv6`` sends those to
    the plain version); the check comes before any build or launch."""
    r = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        wkv6(r, r, r, r, torch.zeros(2, 16))


def test_build_without_nvcc_raises_clearly(tmp_path, monkeypatch):
    """No cached library and no nvcc: a RuntimeError that says so."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["flash_attention"])


def test_library_is_keyed_by_source():
    path = _build.library_path("flash_attention")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("flash_attention-") and path.suffix == ".so"


def test_library_is_keyed_by_shared_headers(tmp_path, monkeypatch):
    """Editing a shared header changes the library's key, so the next
    load rebuilds every source that may include it."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "kern.cu").write_text('#include "shared.cuh"\n')
    header = tmp_path / "shared.cuh"
    header.write_text("#pragma once\n")
    before = _build.library_path("kern")
    assert _build.library_path("kern") == before
    header.write_text("#pragma once\n// edited\n")
    assert _build.library_path("kern") != before


# The kernels' autograd.Functions at the serve shapes of chip_smoke.py
# (smollm-360m's attention, rwkv6-3b's WKV-6, zamba2-2.7b's SSD), bf16 and
# f32. The loss is linear in every output, so the backward gets the same
# incoming gradient whichever forward ran, and the Function's backward IS
# autograd of the plain version on the same inputs: the gradients agree
# to the order of the card's sums (GRAD_TOL); the forward is held to the
# kernel's own limit.
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_DTYPES = (torch.float32, torch.bfloat16)


def _leaves(tensors):
    return [t.detach().clone().requires_grad_() for t in tensors]


def _linear_loss(outs, weights):
    return sum((o.float() * w).sum() for o, w in zip(outs, weights)
               if w is not None)


def _function_vs_plain(kernel_fn, plain_fn, inputs, weights, counter):
    """(outputs, grads) through the Function and through autograd of the
    plain version; the Function launches once, in its forward."""
    before = counter.launches
    xs = _leaves(inputs)
    got = kernel_fn(*xs)
    got_g = torch.autograd.grad(_linear_loss(got, weights), xs)
    assert counter.launches == before + 1
    ys = _leaves(inputs)
    want = plain_fn(*ys)
    want_g = torch.autograd.grad(_linear_loss(want, weights), ys)
    return got, want, got_g, want_g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", GRAD_DTYPES, ids=str)
def test_flash_function_grads_at_the_serve_shape(cuda, dtype):
    B, S, H, KV, D = 4, 1024, 15, 5, 64       # smollm-360m
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (torch.randn(B, S, n, D, generator=g, device=cuda).to(dtype)
               for n in (H, KV, KV))
    w = torch.randn(B, S, H, D, generator=g, device=cuda)
    kw = dict(causal=True, q_chunk=512, kv_chunk=1024)
    got, want, gg, wg = _function_vs_plain(
        lambda *a: (flash_ops.kernel_attention(*a, **kw),),
        lambda *a: (blockwise_attention(*a, **kw),), [q, k, v], [w],
        flash_attention)
    tol = F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
    torch.testing.assert_close(got[0].float(), want[0].float(), **tol)
    for a, b in zip(gg, wg):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), **GRAD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", GRAD_DTYPES, ids=str)
@pytest.mark.parametrize("use_state", [False, True])
def test_wkv6_function_grads_at_the_serve_shape(cuda, dtype, use_state):
    B, S, H, K = 4, 1024, 40, 64              # rwkv6-3b
    g = torch.Generator(device=cuda).manual_seed(12)
    r, k, v = (0.5 * torch.randn(B, S, H, K, generator=g, device=cuda)
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(B, S, H, K, generator=g,
                                         device=cuda) - 2))
    u = 0.3 * torch.randn(H, K, generator=g, device=cuda)
    s0 = 0.3 * torch.randn(B, H, K, K, generator=g, device=cuda)
    wy = torch.randn(B, S, H, K, generator=g, device=cuda)
    ws = torch.randn(B, H, K, K, generator=g, device=cuda) if use_state \
        else None
    inputs = [t.to(dtype) for t in (r, k, v, w)] + [u, s0]
    got, want, gg, wg = _function_vs_plain(
        lambda *a: wkv_ops.kernel_wkv6(*a[:5], s0=a[5], chunk=32),
        lambda *a: wkv6_chunked(*a[:5], s0=a[5], chunk=32), inputs,
        [wy, ws], wkv6)
    tol = WKV_F32_TOL if dtype == torch.float32 else WKV_BF16_TOL
    torch.testing.assert_close(got[0].float(), want[0].float(), **tol)
    for a, b in zip(gg, wg):
        torch.testing.assert_close(a.float(), b.float(), **GRAD_TOL)
        assert a.abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", GRAD_DTYPES, ids=str)
@pytest.mark.parametrize("use_state", [False, True])
def test_ssd_function_grads_at_the_serve_shape(cuda, dtype, use_state):
    B, S, H, P, G, N = 4, 1024, 80, 64, 1, 64   # zamba2-2.7b
    g = torch.Generator(device=cuda).manual_seed(13)
    x = torch.randn(B, S, H, P, generator=g, device=cuda)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=g, device=cuda) - 1)
    a = -torch.exp(0.5 * torch.randn(H, generator=g, device=cuda))
    Bm, Cm = (torch.randn(B, S, G, N, generator=g, device=cuda)
              for _ in range(2))
    D = torch.randn(H, generator=g, device=cuda)
    h0 = 0.3 * torch.randn(B, H, P, N, generator=g, device=cuda)
    wy = torch.randn(B, S, H, P, generator=g, device=cuda)
    wh = torch.randn(B, H, P, N, generator=g, device=cuda) if use_state \
        else None
    inputs = [x.to(dtype), dt, a, Bm.to(dtype), Cm.to(dtype), D, h0]
    got, want, gg, wg = _function_vs_plain(
        lambda *a_: ssd_ops.kernel_ssm_scan(*a_[:6], h0=a_[6], chunk=256),
        lambda *a_: ssm_scan_chunked(*a_[:6], h0=a_[6], chunk=256), inputs,
        [wy, wh], ssm_scan)
    tol = SSD_F32_TOL if dtype == torch.float32 else SSD_BF16_TOL
    torch.testing.assert_close(got[0].float(), want[0].float(), **tol)
    for a_, b in zip(gg, wg):
        torch.testing.assert_close(a_.float(), b.float(), **GRAD_TOL)
        assert a_.abs().max() > 0


@pytest.mark.cuda
def test_raw_wrappers_refuse_grad_under_grad_mode(cuda):
    q = torch.randn(1, 16, 2, 32, device=cuda, requires_grad=True)
    r = torch.rand(1, 16, 2, 16, device=cuda, requires_grad=True)
    u = torch.zeros(2, 16, device=cuda)
    x = torch.randn(1, 16, 2, 16, device=cuda, requires_grad=True)
    ssd = (x, torch.rand(1, 16, 2, device=cuda), -torch.ones(2, device=cuda),
           torch.randn(1, 16, 1, 16, device=cuda),
           torch.randn(1, 16, 1, 16, device=cuda), torch.ones(2, device=cuda))
    for call in (lambda: flash_attention(q, q, q),
                 lambda: wkv6(r, r, r, r, u),
                 lambda: ssm_scan(*ssd)):
        with pytest.raises(RuntimeError, match="requires grad"):
            call()
        with torch.no_grad():
            call()


@pytest.fixture(scope="module")
def mesh11():
    """The card as a (1, 1) mesh over a 1-rank NCCL world."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import socket

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        yield make_debug_mesh(1)
    finally:
        dist.destroy_process_group()


def _on_mesh(mesh, *tensors):
    from torch.distributed.tensor import Replicate, distribute_tensor
    return [None if t is None else
            distribute_tensor(t, mesh, [Replicate(), Replicate()])
            for t in tensors]


def _same_on_mesh(mesh, op, counter, tensors, kw):
    """``op`` on DTensors over the (1, 1) mesh (its local_map region)
    equals ``op`` on the plain tensors bit for bit, and each call
    launches the kernel once."""
    want = op(*tensors, **kw)
    n = counter.launches
    got = op(*_on_mesh(mesh, *tensors), **kw)
    assert counter.launches == n + 1
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for a, b in zip(got, want):
        assert type(a).__name__ == "DTensor"
        assert torch.equal(a.to_local(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_on_a_one_rank_mesh(cuda, mesh11, dtype):
    g = torch.Generator(device=cuda).manual_seed(21)
    q, k, v = (torch.randn(2, 256, n, 64, generator=g, device=cuda)
               .to(dtype) for n in (15, 5, 5))           # smollm's heads
    _same_on_mesh(mesh11, flash_ops.attention, flash_attention, (q, k, v),
                  dict(causal=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_wkv6_on_a_one_rank_mesh(cuda, mesh11, dtype):
    g = torch.Generator(device=cuda).manual_seed(22)
    B, S, H, K = 2, 128, 4, 64
    r, k, v = (0.5 * torch.randn(B, S, H, K, generator=g, device=cuda)
               .to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(B, S, H, K, generator=g,
                                         device=cuda) - 2)).to(dtype)
    u = 0.3 * torch.randn(H, K, generator=g, device=cuda)
    s0 = 0.3 * torch.randn(B, H, K, K, generator=g, device=cuda)
    _same_on_mesh(mesh11, wkv_ops.wkv6, wkv6, (r, k, v, w, u, s0), {})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_ssd_on_a_one_rank_mesh(cuda, mesh11, dtype):
    g = torch.Generator(device=cuda).manual_seed(23)
    B, S, H, P, G, N = 2, 128, 8, 64, 1, 64
    x = torch.randn(B, S, H, P, generator=g, device=cuda).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=g, device=cuda) - 1)
    a = -torch.exp(0.5 * torch.randn(H, generator=g, device=cuda))
    Bm, Cm = (torch.randn(B, S, G, N, generator=g, device=cuda).to(dtype)
              for _ in range(2))
    D = torch.randn(H, generator=g, device=cuda)
    h0 = 0.3 * torch.randn(B, H, P, N, generator=g, device=cuda)
    _same_on_mesh(mesh11, ssd_ops.ssm_scan, ssm_scan,
                  (x, dt, a, Bm, Cm, D, h0), {})
