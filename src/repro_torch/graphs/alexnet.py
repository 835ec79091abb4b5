"""AlexNet as an im2col GEMM sequence.

The paper's most sequentially-chained workload — "every operator takes
only output from the previous convolution layer and static filter weight
as inputs", so on-package redistribution applies between every pair and
AlexNet shows MCMComm's largest gains (Sec. 7.1).

Conv layer → GEMM: M = out_h·out_w·batch, K = C_in·k·k, N = C_out.
"""
from __future__ import annotations

from ..core.workload import GemmOp, Task

# (name, out_spatial, k, c_in, c_out)
_CONVS = [
    ("conv1", 55 * 55, 11, 3, 96),
    ("conv2", 27 * 27, 5, 96, 256),
    ("conv3", 13 * 13, 3, 256, 384),
    ("conv4", 13 * 13, 3, 384, 384),
    ("conv5", 13 * 13, 3, 384, 256),
]
_FCS = [
    ("fc6", 9216, 4096),
    ("fc7", 4096, 4096),
    ("fc8", 4096, 1000),
]


def alexnet_task(batch: int = 1) -> Task:
    ops = []
    first = True
    for name, spatial, k, cin, cout in _CONVS:
        ops.append(
            GemmOp(
                name,
                M=spatial * batch,
                K=cin * k * k,
                N=cout,
                chained=not first,
                epilogue_flops_per_elem=1,  # ReLU in the SIMD unit
            )
        )
        first = False
    for name, k, n in _FCS:
        ops.append(
            GemmOp(
                name,
                M=batch,
                K=k,
                N=n,
                chained=True,
                epilogue_flops_per_elem=1 if name != "fc8" else 0,
            )
        )
    return Task(f"alexnet_b{batch}", ops)
