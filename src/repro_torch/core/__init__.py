"""The paper's analytical engines, the port's own copies of the JAX
package's numpy modules, with a float64 torch evaluator for the card:

  * :mod:`.topology` — mesh geometry: entrance grouping and masks,
    hop matrices (with diagonal links), link enumeration and XY routing
    (``MeshGraph``).
  * :mod:`.hw` — MCM packaging types A–D, Table-2 constants, chiplet
    classes, the per-config :class:`Topology`.
  * :mod:`.workload` — GEMM-sequence tasks and partitions.
  * :mod:`.evaluator` — the end-to-end latency/energy/EDP model
    (Sec. 4.3/4.4) with redistribution and async execution
    (Sec. 5.2/5.3), with the closed-form congestion regime or simulated
    flow congestion; numpy reference backend plus a torch backend on the
    card (:mod:`.evaluator_torch`).
  * :mod:`.netsim` — flow-level NoP simulator (Fig. 3): vectorized
    max-min waterfilling engine + event-driven reference;
    :mod:`.netsim_torch` — the batched engine on the card (the
    hand-written waterfilling kernel), also run by the evaluator's
    ``congestion="flow"`` mode.
  * :mod:`.sweep` — batched sweeps with result caching and checkpointed
    resume: evaluation, GA islands and MIQP lattice points
    (``solve_grid``), pipelining (``pipeline_sweep``), the netsim
    (``netsim_sweep``), multi-tenant placement (``multitenant_sweep``);
    :mod:`.sweep_shard` splits their grid axis across devices
    (``devices="sharded"``, DESIGN.md §15).
  * :mod:`.multitenant` — multi-tenant placement on one (possibly
    heterogeneous) package (DESIGN.md §18): contiguous row-band tenant
    regions, per-tenant inner solves through the engines, NoP
    contention from the flow netsim (one waterfilling launch a solve on
    the card).
  * :mod:`.ga` / :mod:`.miqp` — the two solvers (Sec. 6.2/6.3): the GA's
    python and vectorized numpy engines and its device engine
    (:mod:`.ga_torch`), the HiGHS MILP, and :mod:`.miqp_lattice`, the
    batched lattice-enumeration MIQP engine scored on the card;
    :mod:`.simba` — the heuristic baseline.
  * :mod:`.pipelining` — RCPSP cross-sample pipelining (Sec. 5.4), with
    the batched SGS on the card (:mod:`.pipelining_torch`).
  * :mod:`.cosearch` — the fused cross-layer co-search (DESIGN.md §16):
    one genome over partition × diagonal links × pipeline segments,
    scored through the torch evaluator and the SGS kernel, with a Pareto
    archive on the device and gradient seeds by ``torch.autograd``;
    wired as :func:`.sweep.cosearch_sweep`.
  * :mod:`.api` — one-call front doors, :func:`optimize` and
    ``api.cosearch``.
"""
from . import netsim, netsim_torch  # noqa: F401
from .api import (ScheduleResult, baseline_result, optimize,  # noqa: F401
                  refine_schedule)
# NB: the joint-search front door is ``api.cosearch`` — the name
# ``repro_torch.core.cosearch`` stays bound to the submodule.
from .cosearch import (CoSearchConfig, CoSearchResult,  # noqa: F401
                       run_cosearch)
from .evaluator import (AUTO_POPULATION_THRESHOLD, BACKENDS,  # noqa: F401
                        CONGESTION_MODES, DEVICE_MODES, EvalOptions,
                        EvalResult, Evaluator, resolve_auto_backend)
from .ga import GAConfig, GAResult, run_ga  # noqa: F401
from .hw import (TABLE2, ChipletClass, HWConfig, MCMType,  # noqa: F401
                 Topology, make_hw)
from .miqp import (MIQPConfig, MIQPResult, resolve_auto_engine,  # noqa: F401
                   run_miqp)
from .multitenant import (MultiTenantConfig,  # noqa: F401
                          MultiTenantResult, solve_multitenant)
from .pipelining import (PIPELINE_ENGINES, PipelineConfig,  # noqa: F401
                         PipelineResult, pipeline_batch,
                         resolve_auto_pipeline_engine)
from .sweep import (EvalPoint, MultiTenantPoint,  # noqa: F401
                    PipelinePoint, cosearch_sweep, eval_sweep,
                    multitenant_sweep, netsim_sweep, pipeline_sweep,
                    solve_grid)
from .workload import (GemmOp, Partition, Task,  # noqa: F401
                       clamp_partition_to_domain, partition_domain,
                       uniform_partition)
