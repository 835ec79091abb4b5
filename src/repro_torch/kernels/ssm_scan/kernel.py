"""Python wrapper of the hand-written CUDA SSD scan
(``kernels/csrc/ssm_scan.cu``), the port of the Pallas TPU kernel
``ssm_scan`` in the JAX package, with the contract of the JAX
``ssm_scan_chunked`` that the Mamba-2 layer calls: an initial state in,
the final state out, the ``D·x`` skip added before y is rounded.

B and C are read by group (head h reads group h // (H/G)), and x, B and
C may be strided views, such as the pieces of a split convolution
output. The wrapper checks what the kernel takes and raises on anything
else, allocates y and the final state, and launches on PyTorch's current
stream without synchronising. ``ssm_scan.launches`` counts the launches.
It writes its output itself, so autograd cannot see through it: it
raises on inputs that require grad under grad mode, and training goes
through the ``autograd.Function`` in ``ops``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build, refuse_grad

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATE_DIMS = (8, 16, 64)     # the JAX suite, the calibration, zamba2-2.7b


@functools.cache
def _fn():
    fn = _build.load("ssm_scan").ssm_scan_fwd
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [p] * 9 + [i] * 7 + [i64] * 15 + [p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, dt, a, Bmat, Cmat, D, h0):
    named = (("x", x), ("dt", dt), ("a", a), ("B", Bmat), ("C", Cmat),
             ("D", D), ("h0", h0))
    for name, t in named:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(
                f"ssm_scan: {name} is on {t.device}; the kernel takes CUDA "
                "tensors (ops.ssm_scan sends CPU tensors to the plain "
                "version)")
        if t.device != x.device:
            raise ValueError("ssm_scan: inputs on different devices")
    if x.dtype not in _DTYPES or not (x.dtype == Bmat.dtype == Cmat.dtype):
        raise ValueError("ssm_scan: x, B, C must share one dtype of "
                         f"float32/bfloat16, got {x.dtype}, {Bmat.dtype}, "
                         f"{Cmat.dtype}")
    if x.dim() != 4 or Bmat.dim() != 4 or Bmat.shape != Cmat.shape:
        raise ValueError(f"ssm_scan: x must be (B, S, H, P) and B, C one "
                         f"(B, S, G, N) shape, got {tuple(x.shape)}, "
                         f"{tuple(Bmat.shape)}, {tuple(Cmat.shape)}")
    Bsz, S, H, P = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    if min(Bsz, S, H, P, G) <= 0 or tuple(Bmat.shape[:2]) != (Bsz, S):
        raise ValueError(f"ssm_scan: need nonempty sizes and matching "
                         f"(B, S), got x {tuple(x.shape)}, B "
                         f"{tuple(Bmat.shape)}")
    if H % G:
        raise ValueError(f"ssm_scan: the {G} state groups must divide the "
                         f"{H} heads")
    if N not in STATE_DIMS:
        raise ValueError(f"ssm_scan: state dim N must be one of "
                         f"{STATE_DIMS}, got {N}")
    vec = 16 // x.element_size()      # the kernel reads 16-byte vectors
    if P % vec:
        raise ValueError(f"ssm_scan: head dim P must be a multiple of {vec} "
                         f"for {x.dtype}, got {P}")
    for name, t in (("x", x), ("B", Bmat), ("C", Cmat)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssm_scan: {name} needs a contiguous last dim")
        if t.data_ptr() % 16 or any(
                st % vec for st, n in zip(t.stride()[:3], t.shape) if n > 1):
            raise ValueError(f"ssm_scan: every row of {name} must start "
                             "16-byte aligned (data pointer and strides)")
    if dt.dtype != torch.float32 or tuple(dt.shape) != (Bsz, S, H):
        raise ValueError(f"ssm_scan: dt must be float32 of shape "
                         f"{(Bsz, S, H)}, got {dt.dtype} {tuple(dt.shape)}")
    for name, t, shape in (("a", a, (H,)), ("D", D, (H,)),
                           ("h0", h0, (Bsz, H, P, N))):
        if t is None:
            continue
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"ssm_scan: {name} must be float32 of shape "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan: {name} must be contiguous")
    if h0 is not None and h0.data_ptr() % 16:
        raise ValueError("ssm_scan: h0 must start 16-byte aligned")


def ssm_scan(x, dt, a, Bmat, Cmat, D, h0=None):
    """x (B,S,H,P), dt (B,S,H) f32, a (H,) f32, Bmat/Cmat (B,S,G,N) in x's
    dtype, D (H,) f32, h0 (B,H,P,N) f32 or None (zeros) → (y (B,S,H,P) in
    x's dtype, final state (B,H,P,N) f32)."""
    refuse_grad("ssm_scan", x, dt, a, Bmat, Cmat, D, h0)
    _check(x, dt, a, Bmat, Cmat, D, h0)
    Bsz, S, H, P = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    fn = _fn()
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    hT = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                 Bmat.data_ptr(), Cmat.data_ptr(), D.data_ptr(),
                 None if h0 is None else h0.data_ptr(), y.data_ptr(),
                 hT.data_ptr(), _DTYPES[x.dtype], Bsz, S, H, P, G, N,
                 *x.stride()[:3], *dt.stride(), *Bmat.stride()[:3],
                 *Cmat.stride()[:3], *y.stride()[:3], stream)
    if err:
        raise RuntimeError(f"ssm_scan: kernel launch failed with CUDA error "
                           f"{err}")
    ssm_scan.launches += 1
    return y, hT


ssm_scan.launches = 0
