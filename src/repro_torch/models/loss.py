"""Training losses (the JAX package's ``models/loss.py``): next-token LM
cross-entropy and HuBERT-style masked prediction. Cross-entropy is
computed from log-softmax in f32 with the padded-vocab entries already
masked by the model head.

``fused_lm_loss`` is the memory-efficient training path: it consumes the
final *hidden* states and the unembedding matrix and walks sequence
chunks, each rematerialised (``kernels.remat``), so the (B, S, vocab)
logits never exist: the backward recomputes one chunk's logits at a
time."""
from __future__ import annotations

import torch

from ..kernels import remat
from ..sharding.logical import Spec, local_region, mesh_of, shard, spec_of


def _xent(logits, labels):
    if mesh_of(logits) is not None:
        return _vocab_parallel_xent(logits, labels)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0]


def _vocab_parallel_xent(logits, labels):
    """``_xent`` of DTensor logits split over their vocab (the rule
    ``logits``): each rank takes the max, the sum of exponentials and the
    label's logit over the vocab it holds, in a ``local_map`` region
    (PERF.md §3), and the ranks' parts are combined as a log-sum-exp, so
    no rank gathers the logits (as XLA partitions JAX's log-softmax)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = mesh_of(logits)
    sl = spec_of(logits)
    names = list(mesh.mesh_dim_names)
    vocab = sl[-1] if isinstance(sl[-1], tuple) else (
        () if sl[-1] is None else (sl[-1],))
    rows = () if sl[0] is None else (
        sl[0] if isinstance(sl[0], tuple) else (sl[0],))
    parts = [Shard(0) if n in vocab else Shard(1) if n in rows else
             Replicate() for n in names]
    label = [Partial() if n in vocab else Shard(0) if n in rows else
             Replicate() for n in names]

    def local(lg, t):
        lg = lg.float()
        coord = mesh.get_coordinate() or [0] * len(names)
        r = 0
        for a in vocab:
            i = names.index(a)
            r = r * mesh.shape[i] + coord[i]
        v0, n = r * lg.shape[-1], lg.shape[-1]
        m = lg.amax(-1)
        s = torch.exp(lg - m[..., None]).sum(-1)
        hit = (t >= v0) & (t < v0 + n)
        tl = torch.gather(lg, -1, torch.where(hit, t - v0, 0)[..., None]
                          .long())[..., 0]
        return m[None], s[None], torch.where(hit, tl, 0.0)
    m, s, tl = local_region(local, mesh, (logits, labels),
                            (sl, Spec(*sl[:-1])), (parts, parts, label))
    top = m.amax(0)
    return top + torch.log((s * torch.exp(m - top)).sum(0)) - tl


def lm_loss(logits, tokens, loss_mask=None):
    """Next-token prediction: logits (B,S,V) predict tokens shifted by 1.
    ``loss_mask`` (B,S) marks positions whose *predictions* count (e.g.
    text-only for VLM)."""
    ls = _xent(logits[:, :-1], tokens[:, 1:])
    m = (torch.ones_like(ls) if loss_mask is None
         else loss_mask[:, 1:].float())
    return (ls * m).sum() / torch.clamp_min(m.sum(), 1.0)


def masked_pred_loss(logits, labels, mask):
    """Encoder masked prediction: CE only on masked frames."""
    ls = _xent(logits, labels)
    m = mask.float()
    return (ls * m).sum() / torch.clamp_min(m.sum(), 1.0)


def _piece(h, head, t, m, final_softcap, vocab_size):
    """One chunk's summed masked CE: h (B,c,D), head (D,Vp), t, m (B,c)."""
    lg = shard((h @ head).float(), "logits")
    if final_softcap is not None:
        lg = final_softcap * torch.tanh(lg / final_softcap)
    Vp = head.shape[-1]
    if vocab_size is not None and vocab_size != Vp:
        pad = torch.arange(Vp, device=lg.device) >= vocab_size
        lg = lg.masked_fill(pad, -1e9)
    return (_xent(lg, t) * m).sum()


def fused_lm_loss(hidden, head, targets, *, mask=None, final_softcap=None,
                  vocab_size=None, chunk: int = 512, shift: bool = True):
    """Chunked CE over hidden states: per-position loss for predicting
    ``targets`` (already aligned: position i predicts targets[i]).

    hidden (B,S,D), head (D,Vp), targets (B,S), mask (B,S) or None.
    ``shift=True`` applies the standard next-token shift internally.
    The last chunk is ragged where JAX pads it with masked positions:
    the sums are the same."""
    if shift:
        hidden = hidden[:, :-1]
        targets = targets[:, 1:]
        mask = None if mask is None else mask[:, 1:]
    B, S, _ = hidden.shape
    mask = (torch.ones((B, S), device=hidden.device) if mask is None
            else mask.float())
    c = min(chunk, S)
    tot = hidden.new_zeros((), dtype=torch.float32)
    for s0 in range(0, S, c):
        sl = slice(s0, s0 + c)
        tot = tot + remat(_piece, hidden[:, sl], head, targets[:, sl],
                          mask[:, sl], final_softcap, vocab_size)
    return tot / torch.clamp_min(mask.sum(), 1.0)
