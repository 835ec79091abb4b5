"""The paper's analytical engines, the port's own copies of the JAX
package's numpy modules (plain numpy, no torch needed):

  * :mod:`.topology` — mesh geometry: entrance grouping and masks,
    hop matrices (with diagonal links).
  * :mod:`.hw` — MCM packaging types A–D, Table-2 constants, chiplet
    classes, the per-config :class:`Topology`.
  * :mod:`.workload` — GEMM-sequence tasks and partitions.
  * :mod:`.evaluator` — the end-to-end latency/energy/EDP model
    (Sec. 4.3/4.4) with redistribution and async execution
    (Sec. 5.2/5.3), numpy, the closed-form congestion regime pick.
  * :mod:`.ga` — the Sec.-6.2 genetic algorithm (reference engine).
"""
from .evaluator import EvalOptions, EvalResult, Evaluator  # noqa: F401
from .ga import GAConfig, GAResult, run_ga  # noqa: F401
from .hw import (TABLE2, ChipletClass, HWConfig, MCMType,  # noqa: F401
                 Topology, make_hw)
from .workload import (GemmOp, Partition, Task,  # noqa: F401
                       clamp_partition_to_domain, partition_domain,
                       uniform_partition)
