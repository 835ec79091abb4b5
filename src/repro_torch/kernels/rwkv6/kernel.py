"""Python wrapper of the hand-written CUDA WKV-6 forward
(``kernels/csrc/wkv6.cu``), the port of the Pallas TPU kernel ``wkv6`` in
the JAX package, with the contract of the JAX ``wkv6_chunked`` that the
RWKV-6 layer calls: an initial state in, the final state out.

The wrapper checks what the kernel takes and raises on anything else,
allocates y and the final state, and launches on PyTorch's current
stream without synchronising. ``wkv6.launches`` counts the launches.
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
HEAD_DIMS = (16, 32, 64)


@functools.cache
def _fn():
    fn = _build.load("wkv6").wkv6_fwd
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [p] * 8 + [i] * 5 + [i64] * 15 + [p]
    fn.restype = ctypes.c_int
    return fn


def _check(r, k, v, w, u, s0):
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("s0", s0)):
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(
                f"wkv6: {name} is on {t.device}; the kernel takes CUDA "
                "tensors (ops.wkv6 sends CPU tensors to the plain version)")
        if t.device != r.device:
            raise ValueError("wkv6: inputs on different devices")
    if r.dtype not in _DTYPES or not (r.dtype == k.dtype == v.dtype
                                      == w.dtype):
        raise ValueError("wkv6: r, k, v, w must share one dtype of "
                         f"float32/bfloat16, got {r.dtype}, {k.dtype}, "
                         f"{v.dtype}, {w.dtype}")
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == w.shape):
        raise ValueError(f"wkv6: r, k, v, w must share one (B, S, H, K) "
                         f"shape, got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(w.shape)}")
    B, S, H, K = r.shape
    if min(B, S, H) <= 0:
        raise ValueError(f"wkv6: need nonempty sizes, got {tuple(r.shape)}")
    if K not in HEAD_DIMS:
        raise ValueError(f"wkv6: head dim K must be one of {HEAD_DIMS}, "
                         f"got {K}")
    vec = 16 // r.element_size()      # the kernel reads 16-byte vectors
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.stride(-1) != 1:
            raise ValueError(f"wkv6: {name} needs a contiguous last dim")
        if t.data_ptr() % 16 or any(
                st % vec for st, n in zip(t.stride()[:3], t.shape) if n > 1):
            raise ValueError(f"wkv6: every row of {name} must start "
                             "16-byte aligned (data pointer and strides)")
    for name, t, shape in (("u", u, (H, K)), ("s0", s0, (B, H, K, K))):
        if t is None:
            continue
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"wkv6: {name} must be float32 of shape "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"wkv6: {name} must be contiguous")


def wkv6(r, k, v, w, u, s0=None):
    """r/k/v/w (B,S,H,K), u (H,K) f32, s0 (B,H,K,K) f32 or None (zeros)
    → (y (B,S,H,K) in r's dtype, final state (B,H,K,K) f32)."""
    refuse_grad("wkv6", r, k, v, w, u, s0)
    _check(r, k, v, w, u, s0)
    B, S, H, K = r.shape
    fn = _fn()
    y = torch.empty((B, S, H, K), dtype=r.dtype, device=r.device)
    sT = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), None if s0 is None else s0.data_ptr(),
                 y.data_ptr(), sT.data_ptr(), _DTYPES[r.dtype], B, S, H, K,
                 *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *w.stride()[:3], *y.stride()[:3], stream)
    if err:
        raise RuntimeError(f"wkv6: kernel launch failed with CUDA error "
                           f"{err}")
    wkv6.launches += 1
    return y, sT


wkv6.launches = 0
