"""Python wrapper of the hand-written CUDA waterfilling netsim
(``kernels/csrc/netsim_waterfill.cu``), the counterpart of the JAX
package's ``waterfill_times`` under ``vmap``
(``src/repro/core/netsim_jax.py:79``, ``waterfill_rates`` at ``:43``;
no Pallas kernel): one block runs one simulation's whole event loop.

The wrapper checks what the kernel takes and raises on anything else,
allocates the outputs, and launches on PyTorch's current stream without
synchronising. ``waterfill.launches`` counts the launches.
``step_probe`` launches the kernel file's chain of empty block-argmin
rounds, the measured latency floor of one waterfilling round (not
counted); ``blocks_per_sm`` reads the kernel's occupancy at a shape.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

#: Shared memory a block may use on Hopper (227 KB).
MAX_SMEM = 227 * 1024
#: Flows a simulation may have: one thread each, one block.
MAX_FLOWS = 1024


@functools.cache
def _lib():
    lib = _build.load("netsim_waterfill")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.netsim_waterfill.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.netsim_waterfill.restype = ctypes.c_int
    lib.netsim_round_probe.argtypes = [p, i, i, p]
    lib.netsim_round_probe.restype = ctypes.c_int
    lib.netsim_blocks_per_sm.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.netsim_blocks_per_sm.restype = ctypes.c_int
    return lib


def threads(F: int) -> int:
    """Threads of a block: one per flow, whole warps."""
    return max(32, -(-F // 32) * 32)


def smem_bytes(F: int, L: int, R: int) -> int:
    """Shared memory of a block: residual capacities and 32 partial
    minima (float64), user and fixed counts per link, 32 partial argmins
    and the route lists (int32)."""
    return 8 * (L + 32) + 4 * (2 * L + 32 + F * R)


def _check(caps, routes, msgs):
    for name, t, dtype in (("caps", caps, torch.float64),
                           ("routes", routes, torch.int32),
                           ("msgs", msgs, torch.float64)):
        if t.device.type != "cuda":
            raise ValueError(
                f"netsim_waterfill: {name} is on {t.device}; the kernel "
                "takes CUDA tensors (ops.waterfill sends CPU tensors to "
                "the plain version)")
        if t.dtype != dtype:
            raise ValueError(f"netsim_waterfill: {name} must be {dtype}, "
                             f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"netsim_waterfill: {name} must be "
                             "contiguous")
        if t.device != msgs.device:
            raise ValueError("netsim_waterfill: caps, routes and msgs lie "
                             "on different devices")
    if caps.dim() != 2 or routes.dim() != 3 or msgs.dim() != 3:
        raise ValueError(
            "netsim_waterfill: need caps [N, L], routes [N, F, R], msgs "
            f"[N, S, F]; got {tuple(caps.shape)}, {tuple(routes.shape)}, "
            f"{tuple(msgs.shape)}")
    N, L = caps.shape
    _, F, R = routes.shape
    if routes.shape[0] != N or msgs.shape[0] != N or msgs.shape[2] != F:
        raise ValueError(
            f"netsim_waterfill: shapes disagree: caps {tuple(caps.shape)}, "
            f"routes {tuple(routes.shape)}, msgs {tuple(msgs.shape)}")
    S = msgs.shape[1]
    if min(N, S, F, L, R) <= 0:
        raise ValueError(f"netsim_waterfill: need N, S, F, L, R >= 1, got "
                         f"N={N} S={S} F={F} L={L} R={R}")
    if F > MAX_FLOWS:
        raise ValueError(f"netsim_waterfill: F={F} flows; a block runs at "
                         f"most {MAX_FLOWS} (one thread a flow)")
    if N * S > 2**31 - 1:
        raise ValueError(f"netsim_waterfill: N*S = {N * S} simulations is "
                         "more blocks than a launch takes")
    smem = smem_bytes(F, L, R)
    if smem > MAX_SMEM:
        raise ValueError(f"netsim_waterfill: {smem} B of shared memory for "
                         f"F={F}, L={L}, R={R}; a block has {MAX_SMEM}")


def waterfill(caps: torch.Tensor, routes: torch.Tensor, msgs: torch.Tensor,
              link_bytes: bool = True):
    """``caps`` float64 ``[N, L]``, ``routes`` int32 ``[N, F, R]`` (each
    flow's links, ascending, padded with -1; :func:`.ops.route_lists`),
    ``msgs`` float64 ``[N, S, F]`` on one card → ``(latency [N, S], done
    [N, S, F], link_bytes [N, S, L] or None, rounds [N, S] int32)``, as
    :func:`.ref.waterfill_ref`. Simulation ``s`` of network ``n`` is
    block ``n * S + s``."""
    _check(caps, routes, msgs)
    N, L = caps.shape
    _, F, R = routes.shape
    S = msgs.shape[1]
    dev = msgs.device
    latency = torch.empty((N, S), dtype=torch.float64, device=dev)
    done = torch.empty((N, S, F), dtype=torch.float64, device=dev)
    lb = (torch.zeros((N, S, L), dtype=torch.float64, device=dev)
          if link_bytes else None)
    rounds = torch.empty((N, S), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().netsim_waterfill(
            caps.data_ptr(), routes.data_ptr(), msgs.data_ptr(),
            latency.data_ptr(), done.data_ptr(),
            None if lb is None else lb.data_ptr(), rounds.data_ptr(),
            N, S, F, L, R, stream)
    if err:
        raise RuntimeError(f"netsim_waterfill: kernel launch failed with "
                           f"CUDA error {err}")
    waterfill.launches += 1
    return latency, done, lb, rounds


waterfill.launches = 0


def step_probe(rounds: int, F: int, device) -> torch.Tensor:
    """Launch one block of :func:`threads` ``(F)`` threads running
    ``rounds`` empty block-argmin rounds (the round's warp shuffles,
    shared-memory exchange and two block barriers, no links or flows);
    returns the kernel's output scalar so the work cannot be dropped."""
    out = torch.empty(1, dtype=torch.float64, device=device)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().netsim_round_probe(out.data_ptr(), int(rounds),
                                        threads(int(F)), stream)
    if err:
        raise RuntimeError(f"netsim_round_probe: launch failed with CUDA "
                           f"error {err}")
    return out


def blocks_per_sm(F: int, L: int, R: int) -> int:
    """Blocks of the kernel an SM holds at once at this shape."""
    n = ctypes.c_int(0)
    err = _lib().netsim_blocks_per_sm(int(F), int(L), int(R),
                                      ctypes.byref(n))
    if err:
        raise RuntimeError(f"netsim_blocks_per_sm: CUDA error {err}")
    return n.value
