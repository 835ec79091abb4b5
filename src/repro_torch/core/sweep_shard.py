"""Device-sharded sweep fabric — the grid axis split across devices
(DESIGN.md §15). The counterpart of the JAX package's
``core/sweep_shard.py``, which runs ``shard_map`` over a device mesh.

Every batched engine behind :mod:`.sweep` evaluates a shape group as ONE
call with a leading *grid* (or *island*) axis:
:func:`.evaluator_torch.grid_evaluate`, :func:`.ga_torch.solve_islands`,
:func:`.netsim_torch.simulate_pull_batch` and
:func:`.pipelining_torch.schedule_batch`, and the MIQP lattice's chunked
scoring through ``grid_evaluate``. Those calls run on one device; this
module splits that leading axis across a *mesh*, a sequence of
``torch.device``:

  * :func:`resolve_devices` — the uniform
    ``devices="single"|"sharded"|"auto"`` knob carried by
    ``EvalOptions``/``GAConfig``/``MIQPConfig``/``PipelineConfig`` (and
    overridable per sweep call / per ``OptServer``). ``"auto"`` picks
    ``"sharded"`` iff more than one card exists and the group has ≥ 2
    points; an explicit ``"sharded"`` always goes through
    :func:`sharded_grid_call`, even on a one-entry mesh, so a one-card
    (or card-less) host runs the exact code path a multi-card host runs.
  * :func:`grid_mesh` — the mesh: every local card for a card device,
    the device itself for the CPU, or whatever :func:`use_mesh` set (a
    mesh may name one device several times: ``[cpu] * 3`` splits a grid
    three ways on the host, the card listed three times on the card).
  * :func:`sharded_grid_call` — pad the grid axis to a multiple of the
    mesh size (tail points replicate row 0 — *valid* data, so iterative
    engines such as the waterfilling event loop or the GA's generations
    behave on the padding as on a real point — never zeros), run the
    engine's inner function on each shard on its own device, gather the
    results on the first device and slice back to ``n_points``.

Exactness (the §9 contract, extended): per-point math inside every
engine is lane-independent — no cross-point reduction, no batch-size-
dependent tie-break, and the GA's draws are shaped without the island
axis, so each shard draws what the whole grid would have drawn — so a
point's record is **bitwise identical solo, batched, or sharded**. The
sweep-cache fingerprints therefore normalize the ``devices`` field away
(:func:`.sweep._strip_devices`): one cache serves all three modes.
``tests/test_torch_sweep_shard.py`` pins the contract.

Every shard runs on a host thread of its own (one per mesh entry, under
``torch.cuda.device(dev)`` for a card), so all shards are issued before
any of them syncs: an engine that waits for its device (the GA and the
co-search once a chunk, every engine when it copies its results out)
holds up only its own shard, as JAX's single ``shard_map`` program
does. Results are gathered in mesh order, and the first failing
shard's exception is raised.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from .evaluator import DEVICE_MODES

__all__ = [
    "DEVICE_MODES",
    "device_count",
    "resolve_devices",
    "grid_mesh",
    "use_mesh",
    "sharded_grid_call",
]

_MESH: list[torch.device] | None = None


def device_count() -> int:
    """Local cards (``torch.cuda.device_count()``; 0 without one)."""
    return torch.cuda.device_count()


def resolve_devices(devices: str | None, n_points: int) -> str:
    """Resolve the ``devices`` knob to a concrete execution mode.

    ``None`` means "auto". ``"auto"`` → ``"sharded"`` iff more than one
    card exists and the group carries ≥ 2 points (sharding a single
    point buys nothing); the choice is correctness-neutral — solo ==
    batched == sharded bitwise — so auto-resolution never splits the
    result cache. An explicit ``"sharded"`` is honored on a one-entry
    mesh, so the sharded path is testable anywhere."""
    if devices is None:
        devices = "auto"
    if devices not in DEVICE_MODES:
        raise ValueError(f"unknown devices mode {devices!r}; "
                         f"one of {DEVICE_MODES}")
    if devices == "auto":
        return ("sharded" if device_count() > 1 and n_points >= 2
                else "single")
    return devices


@contextlib.contextmanager
def use_mesh(mesh: Sequence):
    """Within the block, every sharded call splits its grid over
    ``mesh`` (devices or device names; one device may repeat) instead of
    :func:`grid_mesh`'s default. Process-wide, not per thread."""
    global _MESH
    devs = [torch.device(d) for d in mesh]
    if not devs:
        raise ValueError("use_mesh needs at least one device")
    prev, _MESH = _MESH, devs
    try:
        yield devs
    finally:
        _MESH = prev


def grid_mesh(device=None) -> list[torch.device]:
    """The mesh a sharded call on ``device`` splits over: the
    :func:`use_mesh` mesh if one is set; else every local card when
    ``device`` is a card (``None`` means the card, raising without one);
    else ``[device]``."""
    if _MESH is not None:
        return list(_MESH)
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(device_count())]
    return [dev]


def _map(fn, tree):
    """Apply ``fn`` to every array/tensor leaf of nested dicts, tuples
    and lists; other leaves pass through."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    return tree


def _pad0(a, pad: int):
    """``a``'s leading axis extended by ``pad`` copies of row 0."""
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a[:1].expand((pad,) + tuple(a.shape[1:]))])
    a = np.asarray(a)
    return np.concatenate([a, np.broadcast_to(a[:1], (pad,) + a.shape[1:])])


def _on(a, dev: torch.device):
    """A tensor leaf moved to ``dev``; numpy leaves stay on the host
    (the inner function uploads them)."""
    return a.to(dev) if isinstance(a, torch.Tensor) else a


def _concat(parts: list, dev: torch.device):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat([p.to(dev) for p in parts])
    return np.concatenate(parts)


def _gather(outs: list, dev: torch.device):
    """Concatenate per-shard output trees along axis 0 on ``dev``."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _gather([o[k] for o in outs], dev) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_gather([o[i] for o in outs], dev)
                           for i in range(len(first)))
    return _concat(outs, dev)


def sharded_grid_call(inner, args: tuple, batched: tuple, n_points: int,
                      mesh=None):
    """Run ``inner(*args, device=d)`` with the batched args split over
    the mesh.

    ``batched[i]`` splits positional arg ``i`` (an array, a tensor, or a
    dict/tuple of them, each leaf with the grid axis first) along its
    leading axis; ``False`` replicates it to every shard (hyperparameters,
    shared tables). ``inner`` returns a tree of arrays or tensors with
    the grid axis first. ``mesh`` is a sequence of ``torch.device``
    (``None``: :func:`grid_mesh`, every local card). The grid axis is
    padded to a multiple of the mesh size with copies of row 0, each
    shard runs on its device from a thread of its own (all issued before
    any syncs), the outputs are concatenated on the first device (numpy
    outputs on the host) in mesh order and sliced back to
    ``n_points``; the first failing shard's exception is raised."""
    mesh = grid_mesh() if mesh is None else [torch.device(d) for d in mesh]
    if not mesh:
        raise RuntimeError("sharded_grid_call: the mesh is empty (no "
                           "local card)")
    k = len(mesh)
    pad = (-n_points) % k
    if pad:
        args = tuple(_map(lambda a: _pad0(a, pad), x) if b else x
                     for x, b in zip(args, batched))
    per = (n_points + pad) // k
    outs: list = [None] * k
    errors: list = [None] * k

    def run(s: int, dev: torch.device) -> None:
        try:
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                lo, hi = s * per, (s + 1) * per
                shard = tuple(_map(lambda a: _on(a[lo:hi], dev), x) if b
                              else _map(lambda a: _on(a, dev), x)
                              for x, b in zip(args, batched))
                outs[s] = inner(*shard, device=dev)
        except BaseException as e:        # re-raised on the caller's thread
            errors[s] = e

    threads = [threading.Thread(target=run, args=(s, dev),
                                name=f"shard-{s}", daemon=True)
               for s, dev in enumerate(mesh)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None:
            raise e
    out = _gather(outs, mesh[0])
    if pad:
        out = _map(lambda a: a[:n_points], out)
    return out
