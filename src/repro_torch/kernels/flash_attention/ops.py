"""Public attention op: the CUDA flash kernel for CUDA tensors, the plain
blockwise version for CPU tensors. There is no fallback: a kernel that
does not build or launch raises. ``attention_ref`` is the O(S²) oracle
for tests."""
from __future__ import annotations

from .blockwise import blockwise_attention
from .kernel import flash_attention
from .ref import attention_ref  # noqa: F401


def attention(q, k, v, *, causal=True, window=None, softcap=None,
              scale=None, q_chunk: int = 512, kv_chunk: int = 1024):
    """(B, Sq, H, Dk), (B, Skv, KV, Dk), (B, Skv, KV, Dv) → (B, Sq, H, Dv).
    ``q_chunk``/``kv_chunk`` tile the plain version only; the kernel
    picks its own tiles."""
    if q.device.type == "cpu":
        return blockwise_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale,
                                   q_chunk=q_chunk, kv_chunk=kv_chunk)
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap, scale=scale)
