"""Fault tolerance for the training loop (the port of the JAX package's
``runtime/fault_tolerance.py``).

Mechanisms:
  * **Checkpoint/restart** — periodic background checkpoints + restore
    of the latest on start; a crash (or preemption) loses at most
    ``ckpt_every`` steps. The data pipeline is step-addressable, so the
    resume is deterministic.
  * **Bad-step rejection** — a non-finite loss or gradient norm skips the
    optimizer update (keeps the previous state) and counts the incident;
    repeated incidents trigger a restore from the checkpoint.
  * **Retry with restore** — transient execution errors re-run the step;
    persistent ones restore the last checkpoint and continue.
  * **Straggler monitoring** — per-step wall-time EWMA; steps slower than
    ``threshold ×`` EWMA are flagged (``StragglerMonitor``, which the
    optimisation server and the sweeps also use).

A step's metrics may be 0-d device tensors: the loop reads the loss and
the gradient norm in one transfer, its one host sync per step, and times
the step after it.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import torch

__all__ = ["FaultTolerantLoop", "LoopReport", "StragglerMonitor"]


class StragglerMonitor:
    """Per-step wall-time EWMA with a robust cold start.

    Cold-start contract:

    * The first observation can never be flagged at observe time — there
      is no baseline yet — and it seeds the EWMA *provisionally*.
    * If the next observation reveals the seed itself was the outlier
      (seed > ``threshold ×`` the new observation — the classic
      compile-or-build-on-step-0 case), the seed is flagged
      retroactively and the EWMA re-seeds from the steady observation.
    * Flagged observations are never folded into the baseline.
    """

    def __init__(self, threshold: float = 2.0, alpha: float = 0.1):
        self.threshold = threshold
        self.alpha = alpha
        self.ewma: float | None = None
        self.flagged: list[tuple[int, float]] = []
        self._seed: tuple[int, float] | None = None

    def observe(self, step: int, dt: float) -> bool:
        if self.ewma is None:
            self.ewma = dt
            self._seed = (step, dt)      # provisional: step 0 never flags
            return False
        if self._seed is not None:
            if self.ewma > self.threshold * dt:
                # The seed was the outlier, not this step: flag it
                # retroactively and rebase on the steady observation.
                self.flagged.append(self._seed)
                self.ewma = dt
                self._seed = (step, dt)
                return False
            self._seed = None            # seed confirmed by a peer
        is_straggler = False
        if dt > self.threshold * self.ewma:
            self.flagged.append((step, dt))
            is_straggler = True
            # do not fold outliers into the baseline estimate
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler


@dataclasses.dataclass
class LoopReport:
    steps_run: int = 0
    bad_steps: int = 0
    retries: int = 0
    restores: int = 0
    stragglers: int = 0
    losses: list = dataclasses.field(default_factory=list)
    # wall seconds of each accepted step, read after its host sync
    step_s: list = dataclasses.field(default_factory=list)


def _host_values(metrics) -> tuple[float, float]:
    """(loss, grad norm) as Python floats: one device-to-host transfer
    for the tensors among them."""
    vals = [metrics.get("loss", math.nan), metrics.get("grad_norm", 0.0)]
    tensors = [i for i, v in enumerate(vals) if isinstance(v, torch.Tensor)]
    if tensors:
        got = torch.stack([vals[i].detach().float().reshape(())
                           for i in tensors]).tolist()
        for i, g in zip(tensors, got):
            vals[i] = g
    return float(vals[0]), float(vals[1])


class FaultTolerantLoop:
    """Runs ``step_fn(state, batch) -> (state, metrics)`` over
    ``pipeline.at(step)``. ``device`` is where a restored checkpoint's
    tensors go; ``restore_kw`` more arguments of ``restore`` (a mesh
    trainer's placements and mesh)."""

    def __init__(self, step_fn: Callable, pipeline, checkpointer=None,
                 ckpt_every: int = 50, max_retries: int = 2,
                 max_bad_steps: int = 5,
                 straggler: StragglerMonitor | None = None,
                 log: Callable[[str], None] = print, device=None,
                 restore_kw: dict | None = None):
        self.step_fn = step_fn
        self.pipeline = pipeline
        self.ckpt = checkpointer
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.max_bad_steps = max_bad_steps
        self.monitor = straggler or StragglerMonitor()
        self.log = log
        self.device = device
        self.restore_kw = restore_kw or {}

    def _can_restore(self) -> bool:
        return self.ckpt is not None and self.ckpt.latest() is not None

    def _restore(self):
        state, _ = self.ckpt.restore(device=self.device, **self.restore_kw)
        return state

    def run(self, state, start_step: int, n_steps: int) -> tuple:
        report = LoopReport()
        bad_streak = 0
        step = start_step
        last_good = state
        while step < start_step + n_steps:
            batch = self.pipeline.at(step)
            t0 = time.perf_counter()
            try:
                new_state, metrics = self.step_fn(state, batch)
                loss, gnorm = _host_values(metrics)
            except Exception as e:       # transient executor failure
                report.retries += 1
                self.log(f"[ft] step {step}: error {e!r}; retrying")
                if report.retries > self.max_retries:
                    if self._can_restore():
                        self.log("[ft] restoring from checkpoint")
                        state = self._restore()
                        report.restores += 1
                    report.retries = 0
                continue
            dt = time.perf_counter() - t0
            if self.monitor.observe(step, dt):
                report.stragglers += 1
                self.log(f"[ft] step {step}: straggler ({dt:.3f}s vs "
                         f"ewma {self.monitor.ewma:.3f}s)")
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                report.bad_steps += 1
                bad_streak += 1
                self.log(f"[ft] step {step}: non-finite loss/grad — "
                         f"rejected")
                if bad_streak > self.max_bad_steps:
                    self.log("[ft] too many bad steps; restoring")
                    if self._can_restore():
                        state = self._restore()
                        report.restores += 1
                    bad_streak = 0
                step += 1            # skip the poisoned batch
                continue
            bad_streak = 0
            state = new_state
            last_good = state
            report.losses.append(loss)
            report.step_s.append(dt)
            report.steps_run += 1
            if self.ckpt is not None and (step + 1) % self.ckpt_every == 0:
                self.ckpt.save(state, step + 1, background=True)
            step += 1
        if self.ckpt is not None:
            self.ckpt.save(last_good, step, background=False)
        return state, report
