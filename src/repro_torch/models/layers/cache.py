"""In-place writes into the serving caches (ring buffers over the
sequence). On a mesh the cache is a DTensor with its sequence sharded
over ``model`` (``partition_specs.cache_shardings``), where DTensor has no
strategy for an in-place write into a slice of a sharded dim: each rank
writes the slots it holds, in a ``local_map`` region (PERF.md §3)."""
from __future__ import annotations

import torch

from ...sharding.logical import (Spec, local_region, mesh_of, placements,
                                 spec_of)


def _seq_offset(spec, mesh, local_len: int) -> int:
    """The first global slot of this rank's shard of dim 1 under
    ``spec`` (the mesh dims in order, the first outermost)."""
    entry = spec[1]
    axes = () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate() or [0] * len(names)
    idx = 0
    for a in axes:
        i = names.index(a)
        idx = idx * mesh.shape[i] + coord[i]
    return idx * local_len


def _region(write, buf, kv):
    """``write(buf, kv, first slot)`` on the local shards of DTensor
    ``buf`` (kv whole along the sequence), or on the tensors as they are."""
    mesh = mesh_of(buf, kv)
    if mesh is None:
        write(buf, kv, 0)
        return buf
    sb = spec_of(buf)
    skv = Spec(sb[0], *([None] * (kv.dim() - 1)))

    def local(b, t):
        write(b, t, _seq_offset(sb, mesh, b.shape[1]))
        return b
    return local_region(local, mesh, (buf, kv), (sb, skv),
                        list(buf.placements))


def prefill_cache(buf, kv):
    """Write S freshly computed entries into a ring buffer of capacity C,
    in place; returns ``buf``. S ≤ C: plain placement at slots 0..S−1
    (absolute = slot). S > C: keep the last C entries, rotated so the
    entry at absolute position p sits in slot p % C."""
    S = kv.shape[1]

    def write(b, t, c0):
        Cl = b.shape[1]
        C = buf.shape[1]
        if S <= C:
            lo, hi = max(c0, 0), min(c0 + Cl, S)
            if hi > lo:
                b[:, lo - c0:hi - c0].copy_(t[:, lo:hi])
        else:
            full = torch.roll(t[:, S - C:], shifts=(S - C) % C, dims=1)
            b.copy_(full[:, c0:c0 + Cl])
    return _region(write, buf, kv)


def write_slot(buf, kv, slot: int):
    """Decode: write the one entry kv (B, 1, ...) into ring slot ``slot``
    in place; returns ``buf``."""
    def write(b, t, c0):
        if c0 <= slot < c0 + b.shape[1]:
            b[:, slot - c0:slot - c0 + 1].copy_(t)
    return _region(write, buf, kv)


def sharded_decode(partial, qs: tuple, caches: tuple):
    """One decode token's attention over caches whose sequence is split
    over the mesh: ``partial(*qs, *local caches, c0)`` attends over the
    slots a rank holds (c0 its first global slot) and returns (acc (B, 1,
    H, Dv) f32, the sum of p·v, m (B, 1, H), the running max, l (B, 1,
    H), the sum of p), in a ``local_map`` region (PERF.md §3); the
    ranks' partials are then combined as in split-KV (flash-decoding)
    attention. The queries stay whole along their heads."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = mesh_of(*qs, *caches)
    sc = spec_of(caches[0])
    names = list(mesh.mesh_dim_names)

    def axes(entry):
        return () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
    seq, batch = axes(sc[1]), axes(sc[0])
    out_pl = [Shard(0) if n in seq else Shard(1) if n in batch else
              Replicate() for n in names]

    def local(*t):
        c0 = _seq_offset(sc, mesh, t[len(qs)].shape[1])
        return tuple(x[None] for x in partial(*t, c0))
    q_specs = tuple(Spec(sc[0], *([None] * (q.dim() - 1))) for q in qs)
    acc, m, l = local_region(local, mesh, qs + caches,
                             q_specs + tuple(spec_of(c) for c in caches),
                             (out_pl, out_pl, out_pl))
    top = m.amax(0, keepdim=True)
    w = torch.exp(m - top)
    out = (acc * w[..., None]).sum(0) / (l * w).sum(0)[..., None]
    # the batch as the cache's, the rest whole (DTensor may leave the
    # heads split unevenly otherwise)
    return out.redistribute(mesh, placements(
        Spec(sc[0], *([None] * (out.dim() - 1))), mesh))
