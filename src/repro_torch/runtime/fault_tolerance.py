"""Straggler monitoring — the port's copy of the JAX package's
``runtime/fault_tolerance.py`` ``StragglerMonitor``: a per-step
wall-time EWMA that flags steps slower than ``threshold ×`` the EWMA
through :meth:`StragglerMonitor.observe`. The optimisation server
(:mod:`repro_torch.serve.optserver`) watches its batch wall-times with
it, and the sweeps' ``straggler`` argument takes one.

The JAX module's ``FaultTolerantLoop`` drives a training step and a
checkpointer; it comes with the port's training substrate (ROADMAP.md
A.8).
"""
from __future__ import annotations

__all__ = ["StragglerMonitor"]


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
