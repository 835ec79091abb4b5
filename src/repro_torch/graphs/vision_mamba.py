"""Vision Mamba (Vim-S) as a GEMM sequence.

Vim-S: 24 bidirectional SSM blocks, d_model=384, expand=2 (d_inner=768),
d_state=16, dt_rank=24. Projections are GEMMs; the selective scan itself
is a sequential SIMD-class op (folded as epilogue cycles on dt_proj, like
the paper folds softmax). Bidirectionality doubles the x/dt projections
(``weight_bytes_scale=2`` for the shared-weight double pass).

The paper notes Vim uses linear attention — like ViT, only the projection
chains (not the scan) benefit from redistribution.
"""
from __future__ import annotations

from ..core.workload import GemmOp, Task


def vision_mamba_task(batch: int = 1, *, depth: int = 24, d: int = 384,
                      expand: int = 2, d_state: int = 16, dt_rank: int = 24,
                      tokens: int = 197) -> Task:
    m = tokens * batch
    di = expand * d
    ops = [GemmOp("patch_embed", M=m, K=768, N=d)]
    for b in range(depth):
        p = f"blk{b}."
        ops.append(GemmOp(p + "in_proj", M=m, K=d, N=2 * di, chained=True,
                          sync=True))               # RMSNorm before
        # bidirectional x-projection (fwd+bwd share structure): B, C, dt
        ops.append(GemmOp(p + "x_proj", M=m, K=di,
                          N=dt_rank + 2 * d_state, chained=True,
                          weight_bytes_scale=2.0))
        # dt_proj + the selective scan as SIMD epilogue on its output
        ops.append(GemmOp(p + "dt_proj", M=m, K=dt_rank, N=di,
                          chained=True, weight_bytes_scale=2.0,
                          epilogue_flops_per_elem=9 * d_state // 8,
                          sync=True))               # scan = sequential
        ops.append(GemmOp(p + "out_proj", M=m, K=di, N=d, chained=True))
    ops.append(GemmOp("head", M=batch, K=d, N=1000))
    return Task(f"vim_s_b{batch}", ops)
