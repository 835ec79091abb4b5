"""Request model + coalescing for the optimization server (DESIGN.md
§14) — the port's copy of the JAX package's ``serve/coalesce.py``, with
``"torch"`` where it has ``"jax"``.

An optimization request is one point of the same design space the
batched sweep engine (:mod:`repro_torch.core.sweep`, DESIGN.md §9)
already drives: an evaluation (``eval_sweep``), a solver search
(``solve_grid`` — GA, MIQP-lattice, the fused co-search of DESIGN.md
§16, or a multi-tenant placement of DESIGN.md §18), or an RCPSP
pipelining instance (``pipeline_sweep``). The server
coalesces queued requests whose *call key* — (kind, method, objective,
solver config, backend) — is identical into ONE sweep call; the sweep
engine then shape-groups that call into single batched calls (one
kernel launch a group where a kernel serves it) and fingerprints every
point into
the process-wide cache, so a request's result is bit-identical whether
it was served alone or coalesced with a thousand others (the
solo==served contract, an extension of §9's solo==batched).

Validation is the bad-request firewall: :meth:`OptRequest.validate`
raises :class:`BadRequest` for malformed points (wrong point type,
partition sums that don't match the task, unknown objective/method/
backend, non-finite segment durations) *before* the point can reach a
batched call, so one poisoned request can neither kill the worker nor
taint its cohort.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any

import numpy as np

from ..core import sweep
from ..core.cosearch import CoSearchConfig
from ..core.evaluator import EvalOptions
from ..core.ga import GAConfig
from ..core.miqp import MIQPConfig
from ..core.multitenant import MultiTenantConfig
from ..core.pipelining import PipelineConfig

__all__ = ["BadRequest", "OptRequest", "CallKey", "group_requests",
           "KINDS", "SOLVE_METHODS", "OBJECTIVES"]

KINDS = ("eval", "solve", "pipeline")
SOLVE_METHODS = ("ga", "miqp", "cosearch", "multitenant")
OBJECTIVES = ("latency", "energy", "edp")
_BACKENDS = ("numpy", "torch", "auto")

_rid = itertools.count()


class BadRequest(ValueError):
    """Malformed optimization request — rejected per request, never
    allowed to reach (or kill) a batched worker call."""


@dataclasses.dataclass(frozen=True)
class CallKey:
    """Coalescing key: requests sharing a CallKey go through one sweep
    call (which shape-groups internally). All fields are hashable —
    solver configs are frozen dataclasses."""

    kind: str
    method: str
    objective: str
    cfg: Any
    backend: str


@dataclasses.dataclass
class OptRequest:
    """One optimization request.

    ``kind="eval"``     → ``point`` is a :class:`~repro.core.sweep.
    EvalPoint`, served by ``eval_sweep`` (objective/method/cfg unused).
    ``kind="solve"``    → ``point`` is an ``EvalPoint`` whose partition
    is ignored; ``method`` picks GA, MIQP-lattice or the co-search
    (``"cosearch"``, torch backend only — a ``CoSearchResult``), ``cfg``
    the frozen solver config, ``objective`` the fitness;
    ``method="multitenant"``
    takes a :class:`~repro_torch.core.sweep.MultiTenantPoint` and a
    ``MultiTenantConfig``.
    ``kind="pipeline"`` → ``point`` is a :class:`~repro.core.sweep.
    PipelinePoint`, served by ``pipeline_sweep`` (``cfg`` a
    ``PipelineConfig``).
    """

    kind: str
    point: Any
    objective: str = "latency"
    method: str = "ga"
    cfg: Any = None
    backend: str = "torch"
    rid: int = dataclasses.field(default_factory=lambda: next(_rid))

    # ------------------------------------------------------------ keys
    def call_key(self) -> CallKey:
        if self.kind == "eval":
            # objective/method/cfg don't reach eval_sweep — normalize
            # them out so equivalent requests coalesce.
            return CallKey("eval", "-", "-", None, self.backend)
        if self.kind == "pipeline":
            return CallKey("pipeline", "-", "-", self.cfg, self.backend)
        return CallKey("solve", self.method, self.objective, self.cfg,
                       self.backend)

    def shape_signature(self) -> tuple:
        """Shape-group signature (mirrors the sweep engine's grouping,
        DESIGN.md §9) — per-request observability of which batched
        call will serve it; the server reports distinct signatures
        per coalesced call."""
        if self.kind == "pipeline":
            return ("pipeline", len(self.point.segments),
                    int(self.point.batch))
        pt = self.point
        if self.kind == "solve" and self.method == "multitenant":
            return (self.kind, "multitenant",
                    tuple(len(t) for t in pt.tasks),
                    pt.hw.X, pt.hw.Y, pt.hw.mcm_type.value, pt.options)
        return (self.kind, len(pt.task), pt.hw.X, pt.hw.Y,
                pt.hw.mcm_type.value, pt.options)

    # ------------------------------------------------------ validation
    def validate(self) -> None:
        """Raise :class:`BadRequest` on any malformed field. Runs on the
        worker before coalescing; a failure rejects THIS request only."""
        if self.kind not in KINDS:
            raise BadRequest(f"unknown kind {self.kind!r}; one of {KINDS}")
        if self.backend not in _BACKENDS:
            raise BadRequest(f"unknown backend {self.backend!r}; "
                             f"one of {_BACKENDS}")
        if self.kind == "eval" and self.backend == "auto":
            raise BadRequest("eval requests need a concrete backend "
                             "('numpy' | 'torch')")
        if self.kind == "pipeline":
            self._validate_pipeline()
        elif self.kind == "solve" and self.method == "multitenant":
            self._validate_multitenant_point()
        else:
            self._validate_eval_point()
        if self.kind == "solve":
            if self.method not in SOLVE_METHODS:
                raise BadRequest(f"unknown method {self.method!r}; "
                                 f"one of {SOLVE_METHODS}")
            if self.objective not in OBJECTIVES:
                raise BadRequest(f"unknown objective {self.objective!r}; "
                                 f"one of {OBJECTIVES}")
            want = {"ga": GAConfig, "miqp": MIQPConfig,
                    "cosearch": CoSearchConfig,
                    "multitenant": MultiTenantConfig}[self.method]
            if self.cfg is not None and not isinstance(self.cfg, want):
                raise BadRequest(
                    f"cfg for method={self.method!r} must be "
                    f"{want.__name__}, got {type(self.cfg).__name__}")
            if self.method == "cosearch" and self.backend == "numpy":
                # The joint search is one fused device objective —
                # there is no host engine to serve it on.
                raise BadRequest("method='cosearch' needs backend "
                                 "'torch' (or 'auto'); got 'numpy'")

    def _validate_eval_point(self) -> None:
        pt = self.point
        if not isinstance(pt, sweep.EvalPoint):
            raise BadRequest(f"{self.kind} request needs an EvalPoint, "
                             f"got {type(pt).__name__}")
        if not isinstance(pt.options, EvalOptions):
            raise BadRequest("point.options must be EvalOptions")
        self._validate_hw(pt.hw)
        if self.kind == "eval" and pt.partition is not None:
            self._validate_partition(pt)

    def _validate_hw(self, hw) -> None:
        """Re-run the full :meth:`HWConfig.validate` field checks —
        unpickling (the transport every remote request rides in on)
        bypasses ``__post_init__``, so corrupted hetero fields (wrong
        assignment length, nonpositive class rates, out-of-range
        indices) would otherwise reach a batched worker call."""
        try:
            hw.validate()
        except ValueError as e:
            raise BadRequest(f"invalid hardware config: {e}") from e
        except Exception as e:
            raise BadRequest(f"point.hw is not a valid HWConfig: "
                             f"{e}") from e

    def _validate_multitenant_point(self) -> None:
        from ..core.workload import Task

        pt = self.point
        if not isinstance(pt, sweep.MultiTenantPoint):
            raise BadRequest(
                f"solve method='multitenant' needs a MultiTenantPoint, "
                f"got {type(pt).__name__}")
        if not isinstance(pt.options, EvalOptions):
            raise BadRequest("point.options must be EvalOptions")
        self._validate_hw(pt.hw)
        if not isinstance(pt.tasks, tuple) or not pt.tasks:
            raise BadRequest("multitenant point needs a non-empty "
                             "tuple of tenant tasks")
        for t in pt.tasks:
            if not isinstance(t, Task) or len(t) < 1:
                raise BadRequest("every tenant must be a non-empty Task")
        if len(pt.tasks) > pt.hw.X:
            raise BadRequest(
                f"{len(pt.tasks)} tenants need {len(pt.tasks)} row "
                f"bands but the grid has X={pt.hw.X} rows")

    def _validate_partition(self, pt) -> None:
        """Vectorized mirror of :meth:`Partition.validate` — the
        per-op numpy-scalar loop there costs ~0.3 ms/request, which at
        serving rates is the single largest server-side overhead."""
        part, n = pt.partition, len(pt.task)
        try:
            Px, Py = np.asarray(part.Px), np.asarray(part.Py)
            if Px.ndim != 2 or Py.ndim != 2 or Px.shape[0] != n \
                    or Py.shape[0] != n:
                raise BadRequest(
                    f"invalid partition: Px/Py shapes {Px.shape}/"
                    f"{Py.shape} do not match {n} ops")
            M = np.fromiter((op.M for op in pt.task.ops),
                            dtype=np.int64, count=n)
            N = np.fromiter((op.N for op in pt.task.ops),
                            dtype=np.int64, count=n)
            bad = (Px.sum(axis=1) != M) | (Py.sum(axis=1) != N) \
                | (Px < 0).any(axis=1) | (Py < 0).any(axis=1)
            if bad.any():
                i = int(np.argmax(bad))
                raise BadRequest(
                    f"invalid partition: {pt.task.ops[i].name}: "
                    f"sum(Px)={int(Px[i].sum())} != M={M[i]} or "
                    f"sum(Py)={int(Py[i].sum())} != N={N[i]} or "
                    f"negative entries")
        except BadRequest:
            raise
        except Exception as e:
            raise BadRequest(f"invalid partition: {e}") from e

    def _validate_pipeline(self) -> None:
        pt = self.point
        if not isinstance(pt, sweep.PipelinePoint):
            raise BadRequest("pipeline request needs a PipelinePoint, "
                             f"got {type(pt).__name__}")
        if self.cfg is not None and not isinstance(self.cfg,
                                                   PipelineConfig):
            raise BadRequest("pipeline cfg must be PipelineConfig, got "
                             f"{type(self.cfg).__name__}")
        if int(pt.batch) < 1:
            raise BadRequest(f"pipeline batch must be >= 1, got "
                             f"{pt.batch}")
        if len(pt.segments) < 1:
            raise BadRequest("pipeline request needs >= 1 segment")
        try:
            durs = pt.durations()
        except Exception as e:
            raise BadRequest(f"unreadable segments: {e}") from e
        if not np.isfinite(durs).all():
            raise BadRequest("segment durations must be finite")


def group_requests(requests) -> dict[CallKey, list]:
    """Coalesce: bucket requests by :meth:`OptRequest.call_key`,
    preserving arrival order within each bucket. Each bucket becomes ONE
    batched sweep call."""
    groups: dict[CallKey, list] = {}
    for r in requests:
        groups.setdefault(r.call_key(), []).append(r)
    return groups
