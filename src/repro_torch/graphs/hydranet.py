"""HydraNet (Tesla-style multi-task vision network) as a GEMM sequence.

No exact public config exists (DESIGN.md §5); we use the publicly
described shape: a RegNet-ish shared backbone, a BiFPN-style fusion stage,
and three task heads (object detection, lane/edge prediction, traffic
lights) operating on the shared feature map. The backbone is sequentially
chained (redistribution applies); the heads branch — each head's first op
consumes the shared fused features, so only the first head op is chained.
"""
from __future__ import annotations

from ..core.workload import GemmOp, Task

# (name, spatial, k, c_in, c_out) — input 640x480-ish, /2 per stage
_BACKBONE = [
    ("stem", 160 * 120, 7, 3, 32),
    ("s1_c1", 80 * 60, 3, 32, 64),
    ("s1_c2", 80 * 60, 3, 64, 64),
    ("s2_c1", 40 * 30, 3, 64, 128),
    ("s2_c2", 40 * 30, 3, 128, 128),
    ("s3_c1", 20 * 15, 3, 128, 256),
    ("s3_c2", 20 * 15, 3, 256, 256),
    ("s4_c1", 10 * 8, 3, 256, 512),
    ("s4_c2", 10 * 8, 3, 512, 512),
]
_FPN = [
    ("fpn_lat", 20 * 15, 1, 512 + 256, 256),
    ("fpn_fuse", 20 * 15, 3, 256, 256),
]
_HEADS = [
    ("det_c1", 20 * 15, 3, 256, 256),
    ("det_out", 20 * 15, 1, 256, 6 * 9),      # 9 anchors x (4+1+1)
    ("lane_c1", 20 * 15, 3, 256, 128),
    ("lane_out", 20 * 15, 1, 128, 8),
    ("tl_c1", 20 * 15, 3, 256, 128),
    ("tl_out", 20 * 15, 1, 128, 16),
]


def hydranet_task(batch: int = 1) -> Task:
    ops = []
    first = True
    for name, spatial, k, cin, cout in _BACKBONE + _FPN:
        ops.append(GemmOp(name, M=spatial * batch, K=cin * k * k, N=cout,
                          chained=not first, epilogue_flops_per_elem=1))
        first = False
    for j, (name, spatial, k, cin, cout) in enumerate(_HEADS):
        # each head re-reads the shared FPN features: only the op directly
        # following the trunk keeps the chain.
        ops.append(GemmOp(name, M=spatial * batch, K=cin * k * k, N=cout,
                          chained=(j % 2 == 1),     # within-head chain
                          epilogue_flops_per_elem=1))
    return Task(f"hydranet_b{batch}", ops)
