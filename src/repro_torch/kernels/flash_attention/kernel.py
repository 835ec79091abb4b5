"""Python wrapper of the hand-written CUDA flash-attention forward
(``kernels/csrc/flash_attention.cu``), the port of the Pallas TPU kernel
``flash_attention`` in the JAX package.

The kernel is built for head dims Dk, Dv ≤ 256 and for MLA's absorbed
latent heads (Dk, Dv rounding up to 288, 256: minicpm3-4b; or to 576,
512: deepseek-v2, whose 512 value columns run as two slices of 256 in
blocks of their own). The wrapper checks what
the kernel takes and raises on anything else, allocates the output, and
launches on PyTorch's current stream without synchronising.
``flash_attention.launches`` counts the launches.
It writes its output itself, so autograd cannot see through it: it
raises on inputs that require grad under grad mode, and training goes
through the ``autograd.Function`` in ``ops``.
"""
from __future__ import annotations

import ctypes
import functools
import math
import re

import torch

from .. import _build, refuse_grad

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def built_dims() -> tuple[int, tuple[tuple[int, int], ...]]:
    """The CUDA source's one list of the head dims it is built for:
    ``kMaxHeadDim`` (Dk, Dv up to it) and the (Dk, Dv) pairs, rounded up
    to 16, of ``FLASH_WIDE_PAIRS``."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    max_d = re.search(r"constexpr int kMaxHeadDim = (\d+);", src)
    pairs = re.search(r"#define FLASH_WIDE_PAIRS\(X\)(.*)", src)
    return int(max_d[1]), tuple(
        (int(a), int(b))
        for a, b in re.findall(r"X\((\d+),\s*(\d+)\)", pairs[1]))


def supported_dims(dk: int, dv: int) -> bool:
    """Whether the kernel is built for head dims (dk, dv), in either
    dtype."""
    max_d, pairs = built_dims()
    return dk > 0 and dv > 0 and (
        (dk <= max_d and dv <= max_d)
        or (-(-dk // 16) * 16, -(-dv // 16) * 16) in pairs)


@functools.cache
def _fn():
    fn = _build.load("flash_attention").flash_attention_fwd
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = ([p, p, p, p, i] + [i] * 7 + [i64] * 12
                   + [i, i, i, ctypes.c_float, ctypes.c_float, p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, window, softcap, q_offset):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(
                f"flash_attention: {name} is on {t.device}; the kernel "
                "takes CUDA tensors (ops.attention sends CPU tensors to "
                "the plain version)")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D "
                             f"(B, S, heads, dim), got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} needs a contiguous "
                             "last dim")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_attention: q, k, v must share one dtype of "
                         f"float32/bfloat16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    B, Sq, H, Dk = q.shape
    Bk, Skv, KV, Dk2 = k.shape
    if v.shape[:3] != k.shape[:3] or Bk != B or Dk2 != Dk:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if min(B, Sq, Skv, H, KV) <= 0 or H % KV:
        raise ValueError(f"flash_attention: need nonempty sizes and H % KV "
                         f"== 0, got H={H} KV={KV} Sq={Sq} Skv={Skv}")
    if not supported_dims(Dk, v.shape[-1]):
        max_d, pairs = built_dims()
        raise ValueError(
            f"flash_attention: no kernel for head dims Dk={Dk} "
            f"Dv={v.shape[-1]}: it is built for 1..{max_d} each, and for "
            f"(Dk, Dv) rounded up to 16 in {list(pairs)}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got "
                         f"{window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got "
                         f"{softcap}")
    if not 0 <= q_offset < 2 ** 31 - Sq:
        raise ValueError(f"flash_attention: q_offset must be >= 0 and "
                         f"q_offset + Sq < 2^31, got {q_offset}")


def flash_attention(
    q: torch.Tensor,            # (B, Sq, H, Dk)
    k: torch.Tensor,            # (B, Skv, KV, Dk)
    v: torch.Tensor,            # (B, Skv, KV, Dv)
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """``q_offset``: the position of query row 0 (the causal and window
    masks put query row i at q_offset + i)."""
    refuse_grad("flash_attention", q, k, v)
    _check(q, k, v, window, softcap, q_offset)
    B, Sq, H, Dk = q.shape
    _, Skv, KV, Dv = v.shape
    if scale is None:
        scale = 1.0 / math.sqrt(Dk)
    fn = _fn()
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPES[q.dtype], B, Sq, Skv, H, KV, Dk, Dv,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], int(causal), window or 0,
                 int(q_offset), softcap or 0.0, scale, stream)
    if err:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
