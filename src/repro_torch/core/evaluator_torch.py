"""torch backend for the analytical evaluator — float64 tensors on an
explicit device, a grid axis over configurations and a population axis
over candidates.

The counterpart of the JAX package's ``core/evaluator_jax.py``. It
mirrors :meth:`.evaluator.Evaluator._evaluate_batch_numpy` (eqs. 3–12)
op for op, so the two backends agree to float64 round-off; the numpy
implementation stays the reference, and the port holds this module to
it at rtol 1e-9 (``tests/test_torch_evaluator_torch.py``).

Structure:
  * every per-(Task, HWConfig) constant — GEMM dims, hop matrices,
    entrance masks, Table-2 scalars — travels in a constant bundle
    (:func:`consts_from_evaluator`), a dict of numpy arrays that
    :func:`to_device` moves to the device once;
  * :func:`grid_evaluate` takes constants stacked on a leading grid axis
    ``G`` and genomes ``[G, P, ...]`` with an explicit population axis
    ``P``; :func:`batch_evaluate` is its ``G = 1`` case. Both copy
    numpy genomes in and results out; fused callers that keep their
    genomes on the device (the GA's device engine, :mod:`.ga_torch`)
    call :func:`evaluate_tensors` instead, which takes and returns
    device tensors. Plain eager torch: no ``vmap``, no
    ``torch.compile``;
  * float64 throughout: every tensor is created as ``torch.float64``
    (torch's default dtype is float32, and cycle counts overflow float32
    mantissas).

``congestion="flow"`` sends every distribution and every collection
simulation of a call (``2 · G · P · n``) to ONE launch of the
hand-written waterfilling kernel
(:func:`repro_torch.kernels.netsim.ops.waterfill`; on the CPU its plain
version), the counterpart of the JAX package tracing
``netsim_jax.waterfill_times`` per op inside its jit. The route lists
it reads are constants of the topology, uploaded with the rest of the
bundle, so a flow call on the card waits for the device nowhere.
``device=None`` means the card and raises without one
(:func:`repro_torch.device.resolve_device`).

Two inputs serve the co-search (:mod:`.cosearch`): the mesh constants
that diagonal links change may carry the population axis (one call
scores candidates on both meshes), and ``smooth=True`` evaluates the
differentiable relaxation that its gradient seeds descend
(:func:`_evaluate`).

``grid_evaluate.calls`` counts every evaluation by device type
(``"cuda"``, ``"cpu"``), numpy-in or tensor-in, as the kernels' wrappers
count their launches.
"""
from __future__ import annotations

import collections
import contextlib
import functools
from typing import Any, Dict

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.netsim import ops as netsim_ops
from .evaluator import EvalOptions

__all__ = ["EvalConsts", "batch_evaluate", "consts_from_evaluator",
           "evaluate_tensors", "grid_evaluate", "to_device", "upload"]

#: dict of per-(Task, HWConfig) constants: per-op [n], per-chiplet
#: [X, Y], per-row/cross-row [X] / [X-1], per-entrance [E...] arrays,
#: the link-level flow network ([L], [X·Y, L], and the route lists [2,
#: X·Y, X+Y-1]) and 0-d scalars, each with a leading grid axis when
#: stacked.
EvalConsts = Dict[str, Any]

_F8 = torch.float64


def consts_from_evaluator(ev) -> EvalConsts:
    """The constant bundle of a numpy :class:`Evaluator`: float64 (and
    one bool) numpy arrays, equal bit for bit to the JAX package's
    ``consts_from_evaluator``, plus ``flow_routes``: the kernel's int32
    route lists of the distribution and collection incidences ``[2, X·Y,
    X+Y-1]`` (a width fixed by the mesh, so configurations of one shape
    stack). In regime mode the flow keys are 1-element zeros, as in the
    JAX package: consts are stacked per sweep point and moved to the
    device, and regime mode never reads them."""
    hw = ev.hw
    f8 = lambda a: np.asarray(a, dtype=np.float64)  # noqa: E731
    if ev.opts.congestion == "flow":
        flow_cap, dist_inc, coll_inc = ev.top.flow_net()
        width = hw.X + hw.Y - 1
        flow_routes = np.stack([netsim_ops.route_lists(dist_inc, width),
                                netsim_ops.route_lists(coll_inc, width)])
    else:
        flow_cap = dist_inc = coll_inc = np.zeros(1)
        flow_routes = np.zeros(1, dtype=np.int32)
    return {
        "flow_cap": f8(flow_cap),
        "dist_inc": f8(dist_inc), "coll_inc": f8(coll_inc),
        "flow_routes": flow_routes,
        "M": f8(ev.M), "K": f8(ev.K), "N": f8(ev.N),
        "sync": f8(ev.sync),
        "w_scale": f8(ev.w_scale), "epilogue": f8(ev.epilogue),
        "chain_valid": f8(ev.chain_valid),
        "hA": f8(ev.hA), "hW": f8(ev.hW), "h_min": f8(ev.h_min),
        "row_mask": f8(ev.row_mask), "col_mask": f8(ev.col_mask),
        "ent_mask": f8(ev.ent_mask), "ent_pos": f8(ev.ent_pos),
        "is3d": np.asarray(ev.top.entrance_is_3d, dtype=bool),
        "links": f8(ev.links),
        "bw_nop_xy": f8(ev.bw_nop_xy), "freq_xy": f8(ev.freq_xy),
        "row_bw": f8(ev.row_bw), "cross_bw": f8(ev.cross_bw),
        "bw_ent": f8(ev.bw_ent_e), "bw_nop_ent": f8(ev.bw_nop_ent),
        "B": f8(ev.B), "bw_nop_min": f8(ev.bw_nop_min),
        "R": f8(float(hw.R)), "C": f8(float(hw.C)),
        "e_sram": f8(hw.e_sram_bit * 8.0), "e_mem": f8(hw.e_mem_bit * 8.0),
        "e_nop": f8(hw.e_nop_bit_hop * 8.0), "e_mac": f8(hw.e_mac_cycle),
    }


def upload(a, dev: torch.device) -> torch.Tensor:
    """One numpy array (or tensor) on ``dev``. To a card it goes through
    pinned memory without blocking the host, so a caller that uploads
    and then launches syncs nowhere; a tensor already there is
    returned as it is."""
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def to_device(consts: EvalConsts, device=None) -> dict[str, torch.Tensor]:
    """Move a constant bundle (single or grid-stacked) to ``device`` once,
    so repeated calls skip the host-to-device copies (no-op on tensors
    already there)."""
    dev = resolve_device(device)
    return {k: upload(v, dev) for k, v in consts.items()}


def _flow_times(c: dict[str, torch.Tensor], demand, chunk):
    """The distribution and collection phases of every (grid point,
    candidate, op) on the topology's flow network, in one call of the
    waterfilling op: network ``2g`` is point ``g``'s distribution,
    ``2g + 1`` its collection, each with ``P · n`` simulations.
    ``demand``/``chunk`` are ``[G, P, n, X, Y]`` bytes; returns
    per-chiplet distribution completion times ``[G, P, n, X, Y]`` and
    collection latencies ``[G, P, n]``. Chiplets with an empty mesh route
    (on their entrance, or under a 3D stack) are masked to zero bytes,
    as in ``Evaluator._flow_times``."""
    G, P, n, X, Y = demand.shape
    F = X * Y
    d_routed = (c["dist_inc"].sum(dim=-1) > 0).to(_F8)[:, None]  # [G,1,F]
    c_routed = (c["coll_inc"].sum(dim=-1) > 0).to(_F8)[:, None]
    msgs = torch.stack([demand.reshape(G, P * n, F) * d_routed,
                        chunk.reshape(G, P * n, F) * c_routed], dim=1)
    caps = c["flow_cap"][:, None].expand(G, 2, -1).reshape(2 * G, -1
                                                           ).contiguous()
    if demand.device.type == "cpu":
        inc, routes = torch.stack([c["dist_inc"], c["coll_inc"]], 1), None
        inc = inc.reshape((2 * G,) + inc.shape[2:])
    else:                          # the kernel reads the route lists only
        inc, routes = None, c["flow_routes"].reshape(
            (2 * G,) + c["flow_routes"].shape[2:])
    latency, done, _, _ = netsim_ops.waterfill(
        caps, inc, msgs.reshape(2 * G, P * n, F), routes=routes,
        link_bytes=False)
    return (done.reshape(G, 2, P, n, X, Y)[:, 0],
            latency.reshape(G, 2, P, n)[:, 1])


def _evaluate(c: dict[str, torch.Tensor], Px, Py, collectors, redist, *,
              redistribution: bool, async_exec: bool, energy_mode: str,
              congestion: str = "regime", smooth: bool = False
              ) -> dict[str, torch.Tensor]:
    """Line-for-line port of ``Evaluator._evaluate_batch_numpy`` with a
    leading grid axis: constants ``[G, ...]``, ``Px [G, P, n, X]``,
    ``Py [G, P, n, Y]``, ``collectors`` and ``redist`` ``[G, P, n]``.

    The mesh constants that the diagonal links change (``hA``, ``hW``,
    ``h_min``, ``links``: the co-search's ``DIAG_KEYS``) may also carry
    the population axis, ``[G, P, ...]``, so that one call scores
    candidates on different meshes.

    ``smooth=True`` is the JAX package's continuous relaxation for the
    co-search's gradient seeds (``evaluator_jax._eval_single``): the
    tile counts ``ceil(P / unit)`` become ``P / unit``, and ``|x|`` takes
    JAX's derivative at 0 (``+1``), so ``torch.autograd`` gives JAX's
    gradient. Reductions stay ``amax``, which splits a tied maximum's
    gradient evenly, as JAX's ``max`` does. Only the regime congestion
    model is differentiable."""
    G, P, n, X = Px.shape
    Y = Py.shape[-1]
    if smooth and congestion == "flow":
        raise ValueError("smooth=True differentiates the regime "
                         "congestion model only; congestion='flow' has "
                         "no gradient")

    def per_op(k):            # [G, n] -> [G, 1, n]
        return c[k][:, None, :]

    def scalar(k, dims):      # [G] -> [G, 1, ...] over ``dims`` axes
        return c[k].reshape((G,) + (1,) * dims)

    def mesh(k, dims):        # [G, ...] or [G, P, ...] -> [G, 1|P, 1, ...]
        v = c[k]
        if v.dim() == dims + 1:
            v = v[:, None]
        return v[:, :, None]

    B4 = scalar("B", 3)
    R, C = c["R"], c["C"]
    M, K, N = per_op("M"), per_op("K"), per_op("N")
    bw_ent = c["bw_ent"][:, None, None, :]                   # [G,1,1,E]

    redist = redist * per_op("chain_valid")
    if not redistribution:
        redist = torch.zeros_like(redist)
    # redist_in[i] = output of op i-1 was redistributed (A already local).
    redist_in = torch.cat(
        [torch.zeros_like(redist[..., :1]), redist[..., :-1]], dim=-1)
    keepA = 1.0 - redist_in          # fraction of A loads from memory
    redist_out = redist

    # -------------------------------------------------- data volumes
    chunk = Px[..., :, None] * Py[..., None, :] * scalar("B", 4)
    inA = Px * K[..., None] * B4                             # [G,P,n,X]
    inW = Py * (K * per_op("w_scale"))[..., None] * B4       # [G,P,n,Y]

    # --------------------------------------------- phase 1: data load
    A_e = torch.einsum("gex,gpnx->gpne", c["row_mask"], inA)
    W_e = torch.einsum("gey,gpny->gpne", c["col_mask"], inW)
    t_off_in = ((keepA[..., None] * A_e + W_e) / bw_ent).amax(dim=-1)

    tA_xy = inA[..., :, None] * mesh("hA", 2)                # bytes*hops
    tW_xy = inW[..., None, :] * mesh("hW", 2)
    flow_mode = congestion == "flow"
    if flow_mode:
        # Flow congestion: simulated per-chiplet NoP arrival times
        # replace the hop-matrix closed form; off-chip serialization keeps
        # the exact per-entrance term.
        demand = (keepA[..., None, None] * inA[..., :, None]
                  + inW[..., None, :])                       # [G,P,n,X,Y]
        dist_done, t_coll_flow = _flow_times(c, demand, chunk)
        t_in = torch.maximum(t_off_in, dist_done.amax(dim=(-1, -2)))
    else:
        nop_in_xy = ((keepA[..., None, None] * tA_xy + tW_xy)
                     / c["bw_nop_xy"][:, None, None])
        t_in = torch.maximum(t_off_in, nop_in_xy.amax(dim=(-1, -2)))

    # ------------------------------------------------ phase 2: compute
    fill = (2.0 * scalar("R", 2) + scalar("C", 2) + K - 2.0)[..., None, None]
    if smooth:
        tiles = ((Px / scalar("R", 3))[..., :, None]
                 * (Py / scalar("C", 3))[..., None, :])
    else:
        tiles = (torch.ceil(Px / scalar("R", 3))[..., :, None]
                 * torch.ceil(Py / scalar("C", 3))[..., None, :])
    cyc = fill * tiles
    cyc = cyc + (per_op("epilogue")[..., None, None] * Px[..., :, None]
                 * Py[..., None, :] / scalar("C", 4))
    t_comp_xy = cyc / c["freq_xy"][:, None, None]
    t_comp = t_comp_xy.amax(dim=(-1, -2))

    # ----------------------------------------- phase 3a: offload path
    out_e = torch.einsum("gexy,gpnxy->gpne", c["ent_mask"], chunk)
    t_off_out = (out_e / bw_ent).amax(dim=-1)
    if flow_mode:
        # Collection: simulated mesh-flow completion replaces the
        # entrance-link closed form; the off-chip write term stays.
        t_offload = torch.maximum(t_coll_flow, t_off_out)
    else:
        out_at_ent = torch.einsum("gexy,gpnxy->gpne", c["ent_pos"], chunk)
        is3d = c["is3d"][:, None, None, :]
        nonlocal_out = out_e - torch.where(is3d, out_at_ent, 0.0)
        links = mesh("links", 1)                             # [G,1|P,1,E]
        # Dividing by 1 where a link count is 0 keeps the value and its
        # gradient finite; torch.where drops those lanes either way.
        links_safe = torch.where(links > 0, links, 1.0)
        t_collect = torch.where(
            links > 0,
            nonlocal_out / (links_safe * c["bw_nop_ent"][:, None, None, :]),
            0.0,
        ).amax(dim=-1)
        t_offload = torch.maximum(t_collect, t_off_out)

    # --------------------------------- phase 3b: redistribution path
    # (Sec. 5.2) Step 1: row gather toward collector column c.
    yidx = torch.arange(Y, device=Px.device)
    cc = collectors[..., None]
    left_m = (yidx < cc).to(_F8)                             # [G,P,n,Y]
    right_m = (yidx > cc).to(_F8)
    left_x = torch.einsum("gpnxy,gpny->gpnx", chunk, left_m)
    right_x = torch.einsum("gpnxy,gpny->gpnx", chunk, right_m)
    row_bw = c["row_bw"][:, None, None]
    t1 = (torch.maximum(left_x, right_x) / row_bw).amax(dim=-1)
    # Step 2: broadcast the assembled row block along the row.
    rowbytes = Px * N[..., None] * B4                        # [G,P,n,X]
    t2 = (rowbytes / row_bw).amax(dim=-1)
    # Step 3: column redistribution from Px_i to Px_{i+1}, on normalized
    # cumulative fractions scaled by op-i bytes.
    cumf = torch.cumsum(Px, dim=-1) / torch.clamp(M[..., None], min=1.0)
    cumf_next = torch.cat([cumf[:, :, 1:], cumf[:, :, -1:]], dim=2)
    if X > 1:
        dcum = cumf - cumf_next
        # JAX differentiates |x| at 0 as +1; torch.abs as 0.
        adiff = torch.where(dcum >= 0, dcum, -dcum) if smooth else \
            torch.abs(dcum)
        crossing = adiff[..., : X - 1] * M[..., None]
        cross_bytes = crossing * N[..., None] * B4
        t3 = (cross_bytes / c["cross_bw"][:, None, None]).amax(dim=-1)
    else:
        cross_bytes = cumf[..., :0]
        t3 = torch.zeros_like(t1)
    t_redist = t1 + t2 + t3

    t_out = torch.where(redist_out > 0, t_redist, t_offload)

    # Output sync for softmax/layernorm-class ops (eq.-9 convention).
    t_sync = (per_op("sync")
              * (Px.amax(dim=-1) * 4.0 * scalar("B", 2) * max(Y - 1, 1))
              / scalar("bw_nop_min", 2))

    # ------------------------------------------------------- schedule
    if async_exec:
        fused_xy = (dist_done if flow_mode else nop_in_xy) + t_comp_xy
        t_fused = torch.maximum(fused_xy.amax(dim=(-1, -2)), t_off_in)
        core = torch.where(per_op("sync") > 0, t_in + t_comp, t_fused)
    else:
        core = t_in + t_comp
    t_ops = core + t_out + t_sync
    latency = t_ops.sum(dim=-1)

    # --------------------------------------------------------- energy
    sram_bytes = (Y * inA.sum(dim=-1) + X * inW.sum(dim=-1)
                  + chunk.sum(dim=(-1, -2)))
    E_sram = scalar("e_sram", 1) * sram_bytes.sum(dim=-1)

    if energy_mode == "paper":
        # eq. 4.4.1 verbatim: c_MAC * cycles * R * C * (X*Y).
        E_mac = scalar("e_mac", 1) * (
            cyc.amax(dim=(-1, -2)) * scalar("R", 2) * scalar("C", 2)
            * X * Y).sum(dim=-1)
    else:
        E_mac = scalar("e_mac", 1) * (
            cyc.sum(dim=(-1, -2)) * scalar("R", 2)
            * scalar("C", 2)).sum(dim=-1)

    mem_bytes = (keepA[..., None] * A_e + W_e
                 + (1.0 - redist_out)[..., None] * out_e).sum(dim=(-1, -2))
    E_mem = scalar("e_mem", 1) * mem_bytes

    # NoP bytes×hops: loads + (collection | redistribution).
    load_bh = (keepA[..., None, None] * tA_xy + tW_xy).sum(dim=(-1, -2))
    collect_bh = (chunk * mesh("h_min", 2)).sum(dim=(-1, -2))
    red_bh = (
        (left_x + right_x).sum(dim=-1)              # step-1 gather
        + rowbytes.sum(dim=-1) * max(Y - 1, 1)      # step-2 broadcast
        + (cross_bytes.sum(dim=-1) * Y if X > 1 else 0.0)  # step 3
    )
    nop_bh = load_bh + torch.where(redist_out > 0, red_bh, collect_bh)
    E_nop = scalar("e_nop", 1) * nop_bh.sum(dim=-1)

    energy = E_sram + E_mac + E_mem + E_nop
    return {
        "latency": latency,
        "energy": energy,
        "edp": energy * latency,
        "t_in": t_in,
        "t_comp": t_comp,
        "t_out": t_out,
        "E_sram": E_sram,
        "E_mac": E_mac,
        "E_mem": E_mem,
        "E_nop": E_nop,
    }


def evaluate_tensors(c: dict[str, torch.Tensor], opts: EvalOptions,
                     Px, Py, collectors, redist, smooth: bool = False
                     ) -> dict[str, torch.Tensor]:
    """Grid-batched evaluation on device tensors, for callers that keep
    their genomes on the device: constants from :func:`to_device`
    (``[G, ...]``), float64 genomes ``Px [G, P, n, X]``, ``Py [G, P, n,
    Y]``, ``collectors`` and ``redist`` ``[G, P, n]`` on the constants'
    device. Returns float64 tensors there (``[G, P]`` and ``[G, P,
    n]``); copies nothing and never waits for the device. Counted in
    ``grid_evaluate.calls``. ``smooth=True`` (regime congestion only)
    evaluates the differentiable relaxation with autograd on; otherwise
    no graph is recorded."""
    grid_evaluate.calls[Px.device.type] += 1
    with contextlib.nullcontext() if smooth else torch.no_grad():
        return _evaluate(c, Px, Py, collectors, redist,
                         redistribution=bool(opts.redistribution),
                         async_exec=bool(opts.async_exec),
                         energy_mode=opts.energy_mode,
                         congestion=opts.congestion, smooth=smooth)


def _grid_tensors(consts_stack, Px, Py, collectors, redist, *,
                  opts: EvalOptions, device) -> dict[str, torch.Tensor]:
    """One device's grid-batched evaluation: uploads, then
    :func:`evaluate_tensors`; results stay on ``device``."""
    dev = resolve_device(device)
    c = to_device(consts_stack, dev)

    def genome(a):
        return upload(np.asarray(a, dtype=np.float64)
                      if not isinstance(a, torch.Tensor) else a, dev)

    return evaluate_tensors(c, opts, genome(Px), genome(Py),
                            genome(collectors), genome(redist))


def grid_evaluate(consts_stack: EvalConsts, opts: EvalOptions,
                  Px, Py, collectors, redist, device=None,
                  devices: str | None = "single"
                  ) -> dict[str, np.ndarray]:
    """Grid-batched evaluation: every array carries a leading grid axis
    (consts ``[G, ...]``, genomes ``[G, P, ...]``). Returns numpy float64
    arrays with the numpy backend's keys, shaped ``[G, P]`` and
    ``[G, P, n]``.

    ``devices`` (DESIGN.md §15) splits the grid axis over the mesh of
    :mod:`.sweep_shard` (``grid_mesh(device)``); outputs are bitwise
    identical to the single-device call."""
    from . import sweep_shard

    G = int(np.shape(Px)[0])
    if sweep_shard.resolve_devices(devices, G) == "sharded":
        out = sweep_shard.sharded_grid_call(
            functools.partial(_grid_tensors, opts=opts),
            (consts_stack, Px, Py, collectors, redist), (True,) * 5, G,
            mesh=sweep_shard.grid_mesh(device))
    else:
        out = _grid_tensors(consts_stack, Px, Py, collectors, redist,
                            opts=opts, device=device)
    return {k: v.cpu().numpy() for k, v in out.items()}


grid_evaluate.calls = collections.Counter()


def batch_evaluate(consts: EvalConsts, opts: EvalOptions,
                   Px, Py, collectors, redist, device=None
                   ) -> dict[str, np.ndarray]:
    """Population-batched evaluation (genomes ``[P, ...]``, one config):
    the ``G = 1`` case of :func:`grid_evaluate`, outputs ``[P]`` and
    ``[P, n]``."""
    one = {k: v[None] for k, v in consts.items()}
    out = grid_evaluate(one, opts, np.asarray(Px)[None],
                        np.asarray(Py)[None], np.asarray(collectors)[None],
                        np.asarray(redist)[None], device)
    return {k: v[0] for k, v in out.items()}
