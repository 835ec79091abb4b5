"""Public attention op: the CUDA flash kernel for CUDA tensors, the plain
blockwise version for CPU tensors. There is no fallback: a kernel that
does not build or launch raises. ``attention_ref`` is the O(S²) oracle
for tests.

On CUDA tensors the kernel runs inside ``FlashAttention``, an
``autograd.Function``: its forward is the kernel, its backward recomputes
the plain blockwise version on the saved inputs and differentiates it
(the JAX package's training path differentiates the same blockwise
function, rematerialised per KV block). On CPU tensors autograd
differentiates the plain version directly.

On a mesh the kernel runs on each rank's local shard: the batch over the
data axes and the heads over ``model`` when they divide it. Where the
rules hold ``attn_qchunk`` (JAX's sharding point inside its query-chunk
loop, ``kernels/flash_attention/blockwise.py``), the rows of each query
chunk are split over that rule's axes instead, as JAX splits them: each
rank attends its slice of every chunk against all of K and V, at the
slice's positions (``q_offset``), one launch a chunk, so that the causal
work stays balanced across the ranks (``rows_attention``); the slices
come back in sequence order through ``rows_to_sequence``. ``row_region``
holds that layout for every caller: this op on DTensors, and the mesh
regions of GQA attention and MLA.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ...sharding.logical import (Spec, _axes, axis_index, best_spec,
                                 current_rules, gather_dim, heads_specs,
                                 local_region, mesh_of, placements, spec_of)
from .. import kernel_scope, plain_backward
from . import kernel
from .blockwise import blockwise_attention
from .ref import attention_ref  # noqa: F401


class FlashAttention(torch.autograd.Function):
    """forward: ``kernel.flash_attention``; backward: autograd of
    ``blockwise_attention`` at the same options and chunks, recomputed on
    the saved q, k, v. k and v may share storage (MLA passes the latent
    as both): each gets its own gradient, and autograd sums them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, q_offset,
                q_chunk, kv_chunk):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        scale=scale, q_offset=q_offset, q_chunk=q_chunk,
                        kv_chunk=kv_chunk)
        return kernel.flash_attention(q, k, v, causal=causal, window=window,
                                      softcap=softcap, scale=scale,
                                      q_offset=q_offset)

    @staticmethod
    def backward(ctx, grad_out):
        def plain(q, k, v):
            return (blockwise_attention(q, k, v, **ctx.opts),)
        return plain_backward(plain, ctx, (grad_out,), 7)


def kernel_attention(q, k, v, *, causal=True, window=None, softcap=None,
                     scale=None, q_offset: int = 0, q_chunk: int = 512,
                     kv_chunk: int = 1024):
    """The kernel's route, differentiable: forward by the CUDA kernel,
    backward by the plain version (``q_chunk``/``kv_chunk`` tile its
    recompute)."""
    return FlashAttention.apply(q, k, v, causal, window, softcap, scale,
                                q_offset, q_chunk, kv_chunk)


def attention(q, k, v, *, causal=True, window=None, softcap=None,
              scale=None, q_offset: int = 0, q_chunk: int = 512,
              kv_chunk: int = 1024):
    """(B, Sq, H, Dk), (B, Skv, KV, Dk), (B, Skv, KV, Dv) → (B, Sq, H, Dv).
    Query row i sits at position ``q_offset`` + i. ``q_chunk``/``kv_chunk``
    tile the plain version only; the kernel picks its own tiles."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              q_chunk=q_chunk, kv_chunk=kv_chunk)
    mesh = mesh_of(q, k, v)
    if mesh is not None:
        specs = heads_specs(mesh, q, k, v)
        # under attn_qchunk: q, k and v with their batch over the data
        # axes and whole otherwise
        whole = [Spec(s[0], *[None] * (len(s) - 1)) for s in specs]

        def rows(split, out_pl):
            return (local_region(
                lambda a, b, c: rows_attention(a, b, c, split,
                                               q_offset=q_offset, **kw),
                mesh, (q, k, v), whole, out_pl),)
        res = row_region(mesh, specs[0][0], q.shape, q_chunk, rows)
        if res is not None:
            return res[0]
        return local_region(
            lambda a, b, c: attention(a, b, c, q_offset=q_offset, **kw),
            mesh, (q, k, v), specs, placements(specs[0], mesh))
    with kernel_scope("flash_attention"):
        if q.device.type == "cpu":
            return blockwise_attention(q, k, v, q_offset=q_offset, **kw)
        return kernel_attention(q, k, v, q_offset=q_offset, **kw)


class RowSplit(NamedTuple):
    """The rows of each query chunk of c rows split over the mesh
    ``axes`` (a spec entry) into n slices of c / n; this rank holds slice
    ``part``."""

    axes: object
    part: int
    n: int
    c: int


def row_split(mesh, batch_entry, B: int, Sq: int, q_chunk: int):
    """The ``attn_qchunk`` rule of the current rules for a query of B × Sq
    rows cut into chunks of c = min(q_chunk, Sq) rows (JAX's query chunk
    (B, c, KV, G, Dh)) → a ``RowSplit``, or None: no such rule, the rule
    sanitised to no split of the rows, or its row axes among the batch's
    (``batch_entry``, the batch's spec entry). The rule, where set, wins
    over a split of the heads, as JAX's resharding of each chunk does."""
    rule = (current_rules() or {}).get("attn_qchunk")
    if rule is None:
        return None
    c = min(q_chunk, Sq)
    axes = best_spec(rule, (B, c, 1, 1, 1), mesh)[1]
    if axes is None or set(_axes(axes)) & set(_axes(batch_entry)):
        return None
    return RowSplit(axes, *axis_index(mesh, axes), c)


def rows_attention(q, k, v, split: RowSplit, *, q_offset: int = 0,
                   q_chunk: int = 512, **kw):
    """One rank's slice of the rows of every query chunk, attended against
    all of k and v: rows c·i + part·w … c·i + (part + 1)·w − 1 of chunk i
    (w = c / n), each chunk's slice one ``attention`` call at its
    positions → (B, nq·w, H, Dv), chunk after chunk. A ragged last chunk
    is padded with zero query rows, as JAX pads it."""
    Sq, c, n = q.shape[1], split.c, split.n
    w, nq = c // n, -(-Sq // c)
    if nq * c > Sq:
        q = F.pad(q, (0, 0, 0, 0, 0, nq * c - Sq))
    outs = []
    for i in range(nq):
        lo = i * c + split.part * w
        outs.append(attention(q[:, lo:lo + w], k, v,
                              q_offset=q_offset + lo, q_chunk=q_chunk, **kw))
    return torch.cat(outs, dim=1)


def rows_to_sequence(y, mesh, split: RowSplit, Sq: int):
    """DTensor ``y`` (B, n·nq·w, ...) whose dim 1 holds ``rows_attention``'s
    slices, rank after rank over ``split.axes`` → (B, Sq, ...) in sequence
    order, whole along dim 1, its other placements kept."""
    c, n = split.c, split.n
    w, nq = c // n, -(-Sq // c)
    t = torch.arange(Sq)
    # sequence row t = c·i + w·part + j sits at part·nq·w + i·w + j
    src = (t % c) // w * nq * w + t // c * w + t % w
    y = gather_dim(y, 1)
    spec = spec_of(y)

    def order(a):
        return a.index_select(1, src.to(a.device))
    return local_region(order, mesh, (y,), (spec,), placements(spec, mesh))


def row_region(mesh, batch_entry, shape, q_chunk: int, region):
    """The ``attn_qchunk`` layout, decided in this one place for a query
    of ``shape`` (B, Sq, ...) with its batch over ``batch_entry``: where
    the rule splits its rows (``row_split``), ``region(split,
    out_placements)`` runs the caller's ``local_region``, whose first
    output (of ``len(shape)`` dims) holds this rank's rows of each query
    chunk in ``rows_attention``'s order, placed by ``out_placements``
    (the batch over ``batch_entry``, the rows over the rule's axes); that
    output comes back in sequence order (``rows_to_sequence``). → the
    tuple ``region`` returns, so reordered, or None where the rule does
    not split the rows."""
    B, Sq = shape[:2]
    split = row_split(mesh, batch_entry, B, Sq, q_chunk)
    if split is None:
        return None
    spec = Spec(batch_entry, split.axes, *[None] * (len(shape) - 2))
    out, *rest = region(split, placements(spec, mesh))
    return (rows_to_sequence(out, mesh, split, Sq), *rest)
