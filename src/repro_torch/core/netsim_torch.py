"""torch backend for the flow-level netsim — batched max-min waterfilling
on the card. The counterpart of the JAX package's ``core/netsim_jax.py``.

The vectorized numpy engine of :mod:`.netsim`
(:func:`~.netsim.waterfill_rates` / :func:`~.netsim.simulate_flows`)
runs here over a batch of simulations at once:

  * whole (mesh × memory × placement × bandwidth) grids go through ONE
    launch of the hand-written waterfilling kernel
    (:func:`simulate_pull_batch`; ``kernels/csrc/netsim_waterfill.cu``,
    one block a simulation runs its whole event loop, with no host sync);
  * the evaluator's ``congestion="flow"`` mode
    (:mod:`.evaluator_torch`) sends every distribution and collection
    simulation of a call to the same op
    (:func:`repro_torch.kernels.netsim.ops.waterfill`).

On the CPU the op runs the kernel's plain version, the same event loop
in eager torch over the whole batch. Both keep the numpy engine's
float64 operations in its order, so completion times agree with it bit
for bit (``tests/test_torch_netsim.py`` holds them at rtol 1e-9). As in
the JAX engine, a simulation that does not converge or stalls at zero
rate reports NaN; the numpy engine raises. ``device=None`` means the
card and raises without one.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.netsim import ops
from ..kernels.netsim.ref import _rates

__all__ = ["waterfill_rates", "waterfill_times", "simulate_pull_batch"]

_F8 = torch.float64


def waterfill_rates(inc: torch.Tensor, cap: torch.Tensor,
                    active: torch.Tensor) -> torch.Tensor:
    """Max-min fair rates of one network: ``inc [F, L]``, ``cap [L]``,
    ``active [F]`` (bool or 0/1) → rates ``[F]``, by progressive filling
    (at least one link retires a round)."""
    rounds = torch.zeros((1, 1), dtype=torch.int32, device=inc.device)
    return _rates(inc[None], inc.T.contiguous()[None], cap[None],
                  (active > 0)[None, None], rounds)[0, 0]


def waterfill_times(cap: torch.Tensor, inc: torch.Tensor,
                    message_bytes: torch.Tensor):
    """Event-driven simulation of ``F`` concurrent flows on one network
    (``cap [L]``, ``inc [F, L]``, ``message_bytes [F]``) → ``(latency,
    done [F], link_bytes [L])``, NaN where the numpy engine raises. On
    the card one launch of the waterfilling kernel."""
    t, done, lb, _ = ops.waterfill(cap[None], inc[None],
                                   message_bytes[None, None])
    return t[0, 0], done[0, 0], lb[0, 0]


def _pull_batch(caps, incs, msgs, *, device) -> dict[str, torch.Tensor]:
    """One device's batched simulation; results stay on ``device``."""
    dev = resolve_device(device)

    def f8(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)

    if dev.type == "cuda":     # the kernel reads route lists only
        inc, routes = None, torch.from_numpy(
            ops.route_lists(np.asarray(incs))).to(dev)
    else:
        inc, routes = f8(incs), None
    t, done, lb, _ = ops.waterfill(f8(caps), inc, f8(msgs)[:, None],
                                   routes=routes)
    return {"latency": t[:, 0], "done": done[:, 0],
            "link_bytes": lb[:, 0]}


def simulate_pull_batch(caps, incs, msgs, device=None,
                        devices: str | None = "single"
                        ) -> dict[str, np.ndarray]:
    """Batched flow simulation: ``caps [G, L]``, ``incs [G, F, L]``,
    ``msgs [G, F]`` (numpy or tensors) → dict of numpy float64 arrays
    (``latency [G]``, ``done [G, F]``, ``link_bytes [G, L]``). On the
    card the whole grid is one kernel launch. ``devices`` (DESIGN.md
    §15) splits the grid axis over the mesh of :mod:`.sweep_shard`
    (``grid_mesh(device)``), one launch a shard, with bitwise the
    single-device records."""
    from . import sweep_shard

    G = int(np.shape(caps)[0])
    if sweep_shard.resolve_devices(devices, G) == "sharded":
        out = sweep_shard.sharded_grid_call(
            _pull_batch, (caps, incs, msgs), (True, True, True), G,
            mesh=sweep_shard.grid_mesh(device))
    else:
        out = _pull_batch(caps, incs, msgs, device=device)
    return {k: v.cpu().numpy() for k, v in out.items()}
