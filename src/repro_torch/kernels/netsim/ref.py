"""Plain PyTorch version of the batched max-min waterfilling netsim
(``kernels/csrc/netsim_waterfill.cu``): the CPU path of
:func:`.ops.waterfill` and the kernel's oracle on the card.

The counterpart of the JAX package's ``waterfill_times`` under ``vmap``
(``src/repro/core/netsim_jax.py:79``, with ``waterfill_rates`` at
``:43``), event for event and round for round: every simulation of the
batch runs the numpy engine's loop (``core/netsim.py``
``simulate_flows``) at once, masked where it has finished. It reads the
tensors' values to decide when to stop, so it waits for the device once
per event and once per waterfilling round: fine on the CPU and as an
oracle, not on a hot path.

Every float64 operation is the numpy engine's in numpy's order (link
user counts are exact sums of 0/1 values), so ``latency`` and ``done``
equal the numpy engine's bit for bit on the CPU; ``link_bytes`` sums in
a matrix product's order.
"""
from __future__ import annotations

import torch

#: A flow is finished below this many bytes (``core/netsim.py``).
EPS_BYTES = 1e-6
#: Event-loop guard (``core/netsim.py``): a simulation that has not
#: finished after this many events reports NaN.
MAX_EVENTS = 10000

_F8 = torch.float64


def _rates(inc, incT, caps, active, rounds):
    """Max-min fair rates by progressive filling for every simulation:
    ``inc [N, F, L]`` (``incT`` its ``[N, L, F]`` transpose), ``caps [N,
    L]``, ``active [N, S, F]`` bool → rates ``[N, S, F]``. Adds each
    simulation's rounds to ``rounds [N, S]`` in place."""
    N, S, F = active.shape
    L = caps.shape[-1]
    residual = caps[:, None, :].expand(N, S, L).clone()
    unfixed = active.clone()
    rates = torch.zeros((N, S, F), dtype=_F8, device=caps.device)
    for _ in range(L + 1):
        users = torch.matmul(unfixed.to(_F8), inc)            # [N, S, L]
        live = users > 0
        going = live.any(-1)                                  # [N, S]
        if not bool(going.any()):
            break
        share = torch.where(live, residual / torch.where(live, users, 1.0),
                            float("inf"))
        link = share.argmin(-1)                               # first min
        s = torch.where(going, share.gather(-1, link[..., None])[..., 0],
                        0.0)[..., None]                       # [N, S, 1]
        on_link = torch.gather(incT, 1, link[..., None].expand(N, S, F))
        newly = unfixed & (on_link > 0) & going[..., None]
        rates = torch.where(newly, s, rates)
        residual = torch.clamp(
            residual - torch.matmul(newly.to(_F8), inc) * s, min=0.0)
        unfixed &= ~newly
        rounds += going.to(rounds.dtype)
    return rates


def waterfill_ref(caps: torch.Tensor, inc: torch.Tensor, msgs: torch.Tensor,
                  link_bytes: bool = True):
    """``N`` networks of ``L`` links and ``F`` flows, ``S`` simulations
    on each: capacities ``caps [N, L]``, route incidences ``inc [N, F,
    L]`` (0/1), bytes ``msgs [N, S, F]``, all float64 on one device →
    ``(latency [N, S], done [N, S, F], link_bytes [N, S, L] or None,
    rounds [N, S] int32)``. A simulation that stalls at zero rate or
    outlasts :data:`MAX_EVENTS` reports NaN in all three float outputs;
    ``rounds`` counts its waterfilling rounds."""
    N, S, F = msgs.shape
    L = caps.shape[-1]
    dev = msgs.device
    incT = inc.transpose(1, 2).contiguous()
    bl = msgs.clone()
    t = torch.zeros((N, S), dtype=_F8, device=dev)
    done = torch.zeros((N, S, F), dtype=_F8, device=dev)
    lb = torch.zeros((N, S, L), dtype=_F8, device=dev)
    rounds = torch.zeros((N, S), dtype=torch.int32, device=dev)
    bad = torch.zeros((N, S), dtype=torch.bool, device=dev)
    running = (bl > EPS_BYTES).any(-1)
    events = 0
    while bool(running.any()):
        events += 1
        if events > MAX_EVENTS:
            bad |= running
            break
        active = (bl > EPS_BYTES) & running[..., None]
        rates = _rates(inc, incT, caps, active, rounds)
        pos = active & (rates > 0)
        stalled = running & ~pos.any(-1)
        bad |= stalled
        running &= ~stalled
        active &= running[..., None]
        dt = torch.where(pos, bl / torch.where(pos, rates, 1.0),
                         float("inf")).amin(-1)
        dt = torch.where(running, dt, 0.0)[..., None]         # [N, S, 1]
        moved = torch.where(active, rates * dt, 0.0)
        if link_bytes:
            lb += torch.matmul(torch.minimum(moved, bl), inc)
        bl = torch.clamp(bl - moved, min=0.0)
        newly = active & (bl <= EPS_BYTES)
        done = torch.where(newly, t[..., None] + dt, done)
        t = t + dt[..., 0]
        running &= (bl > EPS_BYTES).any(-1)
    nan = float("nan")
    t = torch.where(bad, nan, t)
    done = torch.where(bad[..., None], nan, done)
    lb = torch.where(bad[..., None], nan, lb) if link_bytes else None
    return t, done, lb, rounds
