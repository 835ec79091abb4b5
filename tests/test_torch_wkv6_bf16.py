"""The bf16 WKV-6 kernel's numerics on the CPU: the chunked form of
``kernels/csrc/wkv6.cu`` emulated in PyTorch with every tensor-core
operand rounded to bf16 as the kernel rounds it (each f32 operand split
into bf16 hi + lo), against the plain chunked version and the JAX
package's Pallas kernel in interpret mode on the same numpy inputs, at
the JAX suite's bf16 limit, and at rwkv6-3b's widths against the limit
``chip_smoke.py`` holds the kernel to there. The kernel itself runs only
on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.rwkv6.kernel import wkv6 as jax_pallas
from repro_torch.kernels.rwkv6.chunked import wkv6_chunked

# The JAX suite's bf16 WKV limit (tests/test_kernels.py), rtol = atol.
BF16_TOL = dict(rtol=6e-2, atol=6e-2)
# chip_smoke.py's limit at rwkv6-3b's prefill shape (RWKV_BF16_TOL).
RWKV_BF16_TOL = dict(rtol=1e-2, atol=5e-3)
CHUNK, QUARTER = 32, 4     # the kernel's chunk and its quarters


def _bf(x):
    return x.bfloat16().float()


def _parts(x, split):
    """x as the mma's bf16 operands: hi and lo, or one rounding."""
    hi = _bf(x)
    return (hi, _bf(x - hi)) if split else (hi,)


def _mma(eq, a, b, split=True, b_exact=False):
    """einsum as the kernel's mma sequence: hi.hi + hi.lo + lo.hi of two
    split f32 operands, or hi + lo against a bf16 input (``b_exact``)."""
    ap = _parts(a, split)
    if b_exact:
        return sum(torch.einsum(eq, x, b) for x in ap)
    bp = _parts(b, split)
    out = torch.einsum(eq, ap[0], bp[0])
    for x, y in zip(ap[1:], bp[1:]):
        out = out + torch.einsum(eq, ap[0], y) + torch.einsum(eq, x, bp[0])
    return out


def _wkv6_tensor_core_bf16(r, k, v, w, u, s0=None, split=True):
    """``wkv6_chunked`` as the bf16 kernel computes it: chunks of 32 in 8
    quarters of 4 steps; decays as products of w clamped to [1e-38, 1],
    r~ and k~ normalised inside their quarter; A inside each block of 8 in
    f32 (the quarters' triangles step by step, the 4 x 4 product between
    them), A between blocks of 8, y and the state update from mma operands
    rounded to bf16 (split into hi + lo unless ``split`` is False).
    (B,S,H,K) in, (y in r's dtype, f32 state) out."""
    B, S, H, K = r.shape
    nq = CHUNK // QUARTER
    r32, k32, v32 = (t.float() for t in (r, k, v))
    wc = torch.clamp(w.float(), 1e-38, 1.0)
    pad = (-S) % CHUNK
    if pad:       # padding: k = 0 feeds nothing, w = 1 decays nothing
        r32, k32, v32 = (F.pad(t, (0, 0, 0, 0, 0, pad))
                         for t in (r32, k32, v32))
        wc = F.pad(wc, (0, 0, 0, 0, 0, pad), value=1.0)
    s = (torch.zeros(B, H, K, K) if s0 is None else s0.float())
    ys = []
    for c0 in range(0, r32.shape[1], CHUNK):
        rc, kc, vc, wb = (t[:, c0:c0 + CHUNK] for t in (r32, k32, v32, wc))
        qw = wb.reshape(B, nq, QUARTER, H, K)
        incl = torch.cumprod(qw, dim=2)
        ex = torch.cat([torch.ones_like(incl[:, :, :1]), incl[:, :, :-1]], 2)
        Q = incl[:, :, -1]                                   # (B,nq,H,K)
        rev = torch.flip(torch.cumprod(torch.flip(qw, [2]), 2), [2])
        af = torch.cat([rev[:, :, 1:], torch.ones_like(rev[:, :, :1])], 2)
        rq = rc * ex.reshape(B, CHUNK, H, K)                 # r~
        kq = kc * af.reshape(B, CHUNK, H, K)                 # k~

        def prod(lo, hi):                                    # Q_lo...Q_hi-1
            out = torch.ones(B, H, K)
            for q in range(lo, hi):
                out = out * Q[:, q]
            return out

        A = torch.zeros(B, CHUNK, CHUNK, H)
        for q in range(nq):        # inside the quarters, f32, step by step
            o = QUARTER * q
            for t in range(QUARTER):
                A[:, o + t, o + t] = torch.einsum(
                    "bhk,hk,bhk->bh", rc[:, o + t], u.float(), kc[:, o + t])
                st = kc[:, o + t]
                for i in range(t + 1, QUARTER):
                    A[:, o + i, o + t] = (rc[:, o + i] * st).sum(-1)
                    st = st * wb[:, o + i]
        for m in range(nq // 2):   # between a block's quarters, f32
            o = 8 * m
            A[:, o + 4:o + 8, o:o + 4] = torch.einsum(
                "bihk,bjhk->bijh", rq[:, o + 4:o + 8], kq[:, o:o + 4])
        for I, n in ((0, 0), (1, 0), (1, 1), (1, 2)):    # 16 x 8 tiles
            diag = n == 2 * I
            rows = torch.stack([
                torch.zeros(B, H, K) if diag and hb < 2
                else prod(2 * n + 2, 4 * I + hb) for hb in range(4)], 1)
            rows = rq[:, 16 * I:16 * I + 16] * rows.repeat_interleave(
                QUARTER, 1)
            cols = kq[:, 8 * n:8 * n + 8].clone()
            cols[:, :4] = cols[:, :4] * Q[:, 2 * n + 1, None]
            tile = _mma("bihk,bjhk->bijh", rows, cols, split)
            lo = 8 if diag else 0
            A[:, 16 * I + lo:16 * I + 16, 8 * n:8 * n + 8] = tile[:, lo:]
        E = torch.stack([prod(0, q) for q in range(nq)], 1)   # before q
        Fq = torch.stack([prod(q + 1, nq) for q in range(nq)], 1)  # after
        rE = rq * E.repeat_interleave(QUARTER, 1)
        y = (_mma("bihk,bhkv->bihv", rE, s, split)
             + _mma("bijh,bjhv->bihv", A, vc, split, b_exact=True))
        kF = kq * Fq.repeat_interleave(QUARTER, 1)
        s = (prod(0, nq)[..., None] * s
             + _mma("bjhk,bjhv->bhkv", kF, vc, split, b_exact=True))
        ys.append(y)
    return torch.cat(ys, 1)[:, :S].to(r.dtype), s


def _inputs(shape, seed, state=True, zero_share=0.0, model_w=False):
    """r, k, v, w as chip_smoke.py draws them (unit normals; w =
    exp(-exp(0.5 N)), or rwkv6-3b's exp(-exp(-4 + N)) with ``model_w``),
    u, and s0 or None."""
    B, S, H, K = shape
    rng = np.random.default_rng(seed)
    r, k, v, x = (rng.standard_normal((B, S, H, K)).astype(np.float32)
                  for _ in range(4))
    w = np.exp(-np.exp(x - 4.0 if model_w else 0.5 * x)).astype(np.float32)
    if zero_share:
        w = np.where(rng.random(w.shape) < zero_share, 0.0, w).astype(
            np.float32)
    u = ((0.125 if model_w else 0.3)
         * rng.standard_normal((H, K))).astype(np.float32)
    s0 = ((0.3 * rng.standard_normal((B, H, K, K))).astype(np.float32)
          if state else None)
    return (r, k, v, w), u, s0


def _torch(rkvw, u, s0):
    return ([torch.from_numpy(a).bfloat16() for a in rkvw],
            torch.from_numpy(u), None if s0 is None else torch.from_numpy(s0))


# chip_smoke.py's WKV variants: (B, S, H, K), chunk of the plain version,
# s0, share of decays at 0.
VARIANTS = {
    "s70_c16": ((2, 70, 3, 16), 16, False, 0.0),
    "s1_state": ((2, 1, 3, 16), 16, True, 0.0),
    "k32_s77_state": ((2, 77, 3, 32), 16, True, 0.0),
    "k64_s100_state": ((2, 100, 3, 64), 32, True, 0.0),
    "k64_decay0": ((2, 70, 3, 64), 32, True, 0.25),
}


@pytest.mark.parametrize("name", VARIANTS)
def test_emulation_matches_plain(name):
    shape, chunk, state, zeros = VARIANTS[name]
    (r, k, v, w), u, s0 = _torch(*_inputs(shape, 7, state, zeros))
    got_y, got_s = _wkv6_tensor_core_bf16(r, k, v, w, u, s0)
    want_y, want_s = wkv6_chunked(r, k, v, w, u, s0=s0, chunk=chunk)
    assert torch.isfinite(got_y.float()).all() and torch.isfinite(got_s).all()
    torch.testing.assert_close(got_y.float(), want_y.float(), **BF16_TOL)
    torch.testing.assert_close(got_s, want_s, **BF16_TOL)


def test_emulation_matches_pallas_interpret():
    """y from a zero state against the Pallas kernel (interpret mode) at
    its own chunk of 32; a ragged length."""
    rkvw, u, _ = _inputs((2, 77, 3, 32), 8, state=False)
    jx = [jnp.asarray(a).astype(jnp.bfloat16) for a in rkvw]
    want = jax_pallas(*jx, jnp.asarray(u), chunk=32, interpret=True)
    (r, k, v, w), tu, _ = _torch(rkvw, u, None)
    got, _ = _wkv6_tensor_core_bf16(r, k, v, w, tu)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **BF16_TOL)


def _serve_width(split):
    """One rwkv6-3b layer's WKV at S 256 from a zero state: the kernel's
    rounding against the plain version at chunk 32, as chip_smoke.py
    compares them at S 1024. Returns the largest error beyond rtol."""
    (r, k, v, w), u, _ = _torch(*_inputs((1, 256, 40, 64), 9, False,
                                          model_w=True))
    s0 = torch.zeros(1, 40, 64, 64)
    got_y, got_s = _wkv6_tensor_core_bf16(r, k, v, w, u, s0, split=split)
    want_y, want_s = wkv6_chunked(r, k, v, w, u, s0=s0, chunk=32)
    beyond = ((got_y.float() - want_y.float()).abs()
              - RWKV_BF16_TOL["rtol"] * want_y.float().abs()).max().item()
    return beyond, got_y, want_y, got_s, want_s


def test_serve_width_within_the_serve_limit():
    """With every f32 operand split, the kernel's rounding stays inside
    RWKV_BF16_TOL at rwkv6-3b's widths (PERF.md logs the reading)."""
    _, got_y, want_y, got_s, want_s = _serve_width(split=True)
    torch.testing.assert_close(got_y.float(), want_y.float(),
                               **RWKV_BF16_TOL)
    torch.testing.assert_close(got_s, want_s, **RWKV_BF16_TOL)


def test_serve_width_one_rounding_misses_the_serve_limit():
    """Why the kernel splits: one bf16 rounding of each f32 operand puts y
    beyond RWKV_BF16_TOL's atol at rwkv6-3b's widths (the decays there
    are near 1, and long sums of large terms cancel)."""
    beyond, *_ = _serve_width(split=False)
    assert beyond > RWKV_BF16_TOL["atol"]
