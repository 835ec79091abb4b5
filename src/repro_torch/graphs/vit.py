"""ViT-B/16 as a GEMM sequence.

Attention is a *grouped* GEMM over heads (the paper: "the existence of
attention heads makes the matrix multiplication a grouped GEMM operator,
resulting in more complex data mapping. Therefore, such models only
benefit from on-chip data redistribution in MLP layers") — so the
score/context ops break the redistribution chain (``chained=False``) and
carry ``n_groups=heads``; softmax adds a sync.
"""
from __future__ import annotations

from ..core.workload import GemmOp, Task


def vit_task(batch: int = 1, *, depth: int = 12, d: int = 768,
             heads: int = 12, mlp_ratio: int = 4, tokens: int = 197,
             patch_dim: int = 768) -> Task:
    m = tokens * batch
    ops = [GemmOp("patch_embed", M=m, K=patch_dim, N=d)]
    for b in range(depth):
        p = f"blk{b}."
        ops.append(GemmOp(p + "qkv", M=m, K=d, N=3 * d, chained=True,
                          sync=True))  # layernorm before, heads split after
        # scores: per-head (tokens x d_h) @ (d_h x tokens), heads stacked on
        # M (grouped GEMM flattened — total FLOPs preserved); the "weight"
        # operand is the K activation (one copy per head per sample), and
        # softmax adds a SIMD epilogue + sync.
        dh = d // heads
        ops.append(GemmOp(p + "scores", M=tokens * heads * batch, K=dh,
                          N=tokens, n_groups=heads, sync=True,
                          epilogue_flops_per_elem=5,
                          weight_bytes_scale=float(heads * batch)))
        ops.append(GemmOp(p + "ctx", M=tokens * heads * batch, K=tokens,
                          N=dh, n_groups=heads,
                          weight_bytes_scale=float(heads * batch)))
        ops.append(GemmOp(p + "proj", M=m, K=d, N=d))
        ops.append(GemmOp(p + "fc1", M=m, K=d, N=mlp_ratio * d,
                          chained=True, sync=True,
                          epilogue_flops_per_elem=4))   # GELU
        ops.append(GemmOp(p + "fc2", M=m, K=mlp_ratio * d, N=d,
                          chained=True))
    ops.append(GemmOp("head", M=batch, K=d, N=1000))
    return Task(f"vit_b16_b{batch}", ops)
