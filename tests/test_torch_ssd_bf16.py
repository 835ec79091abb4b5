"""The bf16 SSD kernel's numerics on the CPU: the chunked form of
``kernels/csrc/ssm_scan.cu`` emulated in PyTorch with every tensor-core
operand rounded to bf16 as the kernel rounds it (W, h and the scaled x
split into bf16 hi + lo; x, B and C are bf16 inputs), against the plain
chunked version and the JAX package's Pallas kernel in interpret mode on
the same numpy inputs, at the JAX suite's bf16 limit, and at
zamba2-2.7b's widths. The kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.ssm_scan.kernel import ssm_scan as jax_pallas
from repro_torch.kernels.ssm_scan.chunked import ssm_scan_chunked

# The JAX suite's bf16 SSD limit (tests/test_kernels.py), rtol = atol;
# chip_smoke.py holds the kernel to it at every variant and at
# zamba2-2.7b's prefill shape (SSD_TOL).
BF16_TOL = dict(rtol=6e-2, atol=6e-2)
CHUNK = 64                    # the kernel's chunk


def _bf(x):
    return x.bfloat16().float()


def _mma(eq, a, b, split=True):
    """einsum of an f32 operand ``a`` against a bf16 input ``b`` as the
    kernel's mma: hi + lo of ``a``, or one rounding without ``split``."""
    hi = _bf(a)
    out = torch.einsum(eq, hi, b)
    return out + torch.einsum(eq, _bf(a - hi), b) if split else out


def _ssd_tensor_core_bf16(x, dt, a, Bm, Cm, D, h0=None, split=True):
    """``ssm_scan_chunked`` as the bf16 kernel computes it: chunks of 64;
    W = (C Bᵀ) ∘ exp(cum_i − cum_j) ∘ dt_j, h and dt·exp(cum_L − cum)·x
    in f32, each rounded to bf16 for its product (split into hi + lo
    unless ``split`` is False); exp(cum_i) and D·x applied in f32."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    x32, dt32 = x.float(), dt.float()
    B32 = Bm.float().repeat_interleave(rep, 2)
    C32 = Cm.float().repeat_interleave(rep, 2)
    pad = (-S) % CHUNK
    if pad:       # padding: dt = 0, x = B = C = 0
        x32, B32, C32 = (F.pad(t, (0, 0, 0, 0, 0, pad))
                         for t in (x32, B32, C32))
        dt32 = F.pad(dt32, (0, 0, 0, pad))
    h = (torch.zeros(Bsz, H, P, N) if h0 is None else h0.float())
    tri = torch.tril(torch.ones(CHUNK, CHUNK, dtype=torch.bool))
    ys = []
    for c0 in range(0, x32.shape[1], CHUNK):
        xk, dk, Bk, Ck = (t[:, c0:c0 + CHUNK] for t in (x32, dt32, B32, C32))
        cum = torch.cumsum(dk * a.float(), 1)                  # (B,L,H)
        diff = cum[:, :, None] - cum[:, None]                  # (B,i,j,H)
        L = torch.where(tri[None, :, :, None], torch.exp(
            torch.where(tri[None, :, :, None], diff, 0.0)), 0.0)
        W = torch.einsum("bihn,bjhn->bijh", Ck, Bk) * L * dk[:, None]
        y = (torch.exp(cum)[..., None]
             * _mma("bhpn,bihn->bihp", h, Ck, split)
             + _mma("bijh,bjhp->bihp", W, xk, split))
        s = dk * torch.exp(cum[:, -1:] - cum)
        h = (torch.exp(cum[:, -1])[..., None, None] * h
             + _mma("bjhp,bjhn->bhpn", xk * s[..., None], Bk, split))
        ys.append(y)
    y = torch.cat(ys, 1)[:, :S] + x.float() * D.float()[None, None, :, None]
    return y.to(x.dtype), h


def _inputs(shape, seed, state=True, dt_scale=1.0):
    """x, dt (post-softplus), a < 0, B, C, D and h0 (or None) as
    chip_smoke.py draws them, x/B/C in bf16."""
    B, S, H, P, G, N = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, S, H, P))).bfloat16()
    dt = torch.from_numpy(dt_scale * np.log1p(np.exp(
        rng.standard_normal((B, S, H))))).float()
    a = torch.from_numpy(-np.exp(0.5 * rng.standard_normal(H))).float()
    Bm, Cm = (torch.from_numpy(rng.standard_normal((B, S, G, N))).bfloat16()
              for _ in range(2))
    D = torch.from_numpy(0.1 * rng.standard_normal(H)).float()
    h0 = (torch.from_numpy(0.3 * rng.standard_normal((B, H, P, N))).float()
          if state else None)
    return (x, dt, a, Bm, Cm, D), h0


# chip_smoke.py's SSD variants: (B, S, H, P, G, N), chunk of the plain
# version, h0, scale of dt.
VARIANTS = {
    "jax_s100_c32": ((2, 100, 4, 16, 2, 8), 32, False, 1.0),
    "s1_state": ((2, 1, 4, 16, 2, 8), 32, True, 1.0),
    "g1_n64_p64_s100_state": ((2, 100, 3, 64, 1, 64), 64, True, 1.0),
    "n64_decay0": ((2, 70, 4, 64, 1, 64), 32, True, 40.0),
    "calib_n16_p16_s256_c64": ((1, 256, 2, 16, 1, 16), 64, False, 1.0),
}


@pytest.mark.parametrize("name", VARIANTS)
def test_emulation_matches_plain(name):
    shape, chunk, state, dt_scale = VARIANTS[name]
    args, h0 = _inputs(shape, 7, state, dt_scale)
    got_y, got_h = _ssd_tensor_core_bf16(*args, h0=h0)
    want_y, want_h = ssm_scan_chunked(*args, h0=h0, chunk=chunk)
    assert torch.isfinite(got_y.float()).all() and torch.isfinite(got_h).all()
    torch.testing.assert_close(got_y.float(), want_y.float(), **BF16_TOL)
    torch.testing.assert_close(got_h, want_h, **BF16_TOL)


def test_emulation_matches_pallas_interpret():
    """y from a zero state against the Pallas kernel (interpret mode) at
    the kernel's chunk of 64; a ragged length, two state groups."""
    (x, dt, a, Bm, Cm, D), _ = _inputs((2, 100, 4, 16, 2, 8), 8, False)
    jx = [jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
        for t in (x, dt, a, Bm, Cm, D)]
    want = jax_pallas(*jx, chunk=CHUNK, interpret=True)
    got, _ = _ssd_tensor_core_bf16(x, dt, a, Bm, Cm, D)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **BF16_TOL)


def _serve_width(split):
    """One zamba2-2.7b layer's SSD at S 256 from a zero state: the
    kernel's rounding against the plain version at chunk 256, as
    chip_smoke.py compares them at S 1024. Returns the largest error of
    y beyond rtol."""
    args, _ = _inputs((1, 256, 80, 64, 1, 64), 9, state=False)
    h0 = torch.zeros(1, 80, 64, 64)
    got_y, got_h = _ssd_tensor_core_bf16(*args, h0=h0, split=split)
    want_y, want_h = ssm_scan_chunked(*args, h0=h0, chunk=256)
    beyond = ((got_y.float() - want_y.float()).abs()
              - BF16_TOL["rtol"] * want_y.float().abs()).max().item()
    return beyond, got_y, want_y, got_h, want_h


def test_serve_width_within_ten_times_under_the_limit():
    """With W, h and the scaled x split, y sits over ten times inside
    the JAX limit at zamba2-2.7b's widths (PERF.md logs the reading)."""
    beyond, got_y, want_y, got_h, want_h = _serve_width(split=True)
    assert beyond < BF16_TOL["atol"] / 10
    torch.testing.assert_close(got_h, want_h, **BF16_TOL)


def test_serve_width_one_rounding_reaches_the_limit():
    """Why the kernel splits: with one bf16 rounding of each f32 operand
    y's error beyond rtol reaches past a third of the JAX limit's atol at
    zamba2-2.7b's widths (past the whole of it with this seed), with no
    margin left for the serve shape's sixteen times more values."""
    beyond, *_ = _serve_width(split=False)
    assert beyond > BF16_TOL["atol"] / 3
