"""Public batched waterfilling op: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors. There is no fallback: a kernel that does
not build or launch raises."""
from __future__ import annotations

import numpy as np
import torch

from .kernel import waterfill as waterfill_kernel
from .ref import waterfill_ref


def route_lists(inc: np.ndarray, width: int | None = None) -> np.ndarray:
    """Route incidences ``[..., F, L]`` (0/1) → each flow's link indices
    ``[..., F, width]`` int32, ascending, padded with -1: the kernel's
    route structure. ``width`` defaults to the longest route (at least
    1); a route longer than ``width`` raises."""
    inc = np.asarray(inc) > 0
    longest = int(inc.sum(-1).max(initial=0))
    width = max(longest, 1) if width is None else int(width)
    if longest > width:
        raise ValueError(f"route_lists: a route of {longest} links does "
                         f"not fit in width {width}")
    # Stable sort of "not on the route" puts each route's links first,
    # in ascending order.
    order = np.argsort(~inc, axis=-1, kind="stable")[..., :width]
    on = np.take_along_axis(inc, order, axis=-1)
    return np.where(on, order, -1).astype(np.int32)


def waterfill(caps: torch.Tensor, inc: torch.Tensor | None,
              msgs: torch.Tensor,
              routes: torch.Tensor | None = None, link_bytes: bool = True):
    """``caps [N, L]``, ``inc [N, F, L]``, ``msgs [N, S, F]`` float64 →
    ``(latency [N, S], done [N, S, F], link_bytes [N, S, L] or None,
    rounds [N, S])``. On the card the kernel reads ``routes`` (the
    :func:`route_lists` of ``inc``, int32 on the card, and then ``inc``
    may be None); a caller that passes none has them built here, which
    copies ``inc`` to the host once."""
    if msgs.device.type == "cpu":
        return waterfill_ref(caps, inc, msgs, link_bytes)
    if routes is None:
        routes = torch.from_numpy(route_lists(inc.cpu().numpy())).to(
            msgs.device)
    return waterfill_kernel(caps, routes, msgs, link_bytes)
