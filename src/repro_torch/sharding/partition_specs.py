"""Per-arch partition specs (the port of the JAX package's
``sharding/partition_specs.py``): parameter specs by tree-path semantics
(2-D FSDP over ``data`` × TP over ``model``, MaxText-style) and logical
activation rules. The ``pod`` axis is pure data parallelism: parameters
are replicated across pods and only gradient all-reduces cross the pod
boundary, matching the multi-pod production layout.

The port's parameters are a flat dict of names, one tensor per layer;
JAX's are stacked over the layers. The rules are JAX's, read on the JAX
leaf: its path in the JAX tree and its stacked rank
(``models.convert.jax_leaf_paths``), and the stack dims are dropped from
the result. ``_rule_for`` pads and falls back on the rank, so the port's
own rank would give RWKV's rank-2 time-mix weights and the norms other
specs than JAX's.

Every assignment is sanitised against divisibility, so non-divisible kv
head counts, expert counts, odd vocabs or batch=1 cells degrade to
replication on that dim.
"""
from __future__ import annotations

from ..models.convert import jax_leaf_paths
from .logical import Spec as P
from .logical import _axes, axis_sizes, best_spec, placements, sanitize_spec

DATA, MODEL, POD = "data", "model", "pod"

# Canonical trailing-dims spec per parameter name (JAX's table). Leading
# (stack) dims are padded with None at application time.
_PARAM_RULES: dict = {
    # embeddings / heads
    "embed": P(MODEL, DATA),
    "lm_head": P(DATA, MODEL),
    "patch_proj": P(None, DATA),
    "frame_proj": P(None, DATA),
    "mask_emb": P(None),
    # attention (GQA)
    "wq": P(DATA, MODEL, None),
    "wk": P(DATA, MODEL, None),
    "wv": P(DATA, MODEL, None),
    "wo": P(MODEL, None, DATA),
    # MLA (fallbacks relocate the axis when head counts don't divide)
    "wq_a": P(DATA, MODEL),
    "wq_b": [P(None, MODEL, None), P(DATA, None, None)],
    "wkv_a": P(DATA, None),
    "wk_b": [P(None, MODEL, None), P(DATA, None, None)],
    "wv_b": [P(None, MODEL, None), P(DATA, None, None)],
    # MLP
    "w_gate": P(DATA, MODEL),
    "w_up": P(DATA, MODEL),
    "w_down": P(MODEL, DATA),
    # MoE (fallback: TP the expert FFN dim when n_experts doesn't divide
    # the model axis, the mixtral 8-expert case)
    "router": P(DATA, None),
    "moe_w_gate": [P(MODEL, DATA, None), P(None, DATA, MODEL)],
    "moe_w_up": [P(MODEL, DATA, None), P(None, DATA, MODEL)],
    "moe_w_down": [P(MODEL, None, DATA), P(None, MODEL, DATA)],
    # Mamba2
    "in_proj": P(DATA, MODEL),
    "conv_w": P(None, MODEL),
    "out_proj": P(MODEL, DATA),
    # RWKV6
    "wr": P(DATA, MODEL),
    "ck": P(DATA, MODEL),
    "cv": P(MODEL, DATA),
    "cr": P(DATA, MODEL),
    "wg": P(DATA, MODEL),
    "mix_A": P(DATA, None),
    "mix_B": P(None, None, DATA),
    "decay_A": P(DATA, None),
    "decay_B": P(None, DATA),
    "down": P(DATA, None),   # zamba2 shared-block down projection
}


def _rule_for(path: tuple, rank: int) -> list | None:
    """Candidates for the JAX leaf at ``path`` of (stacked) ``rank``,
    padded to that rank; None: replicate (norms, scalars)."""
    name = path[-1]
    in_moe = "moe" in path
    in_rwkv = "time" in path
    if in_rwkv and name in ("wq", "wk", "wv", "wo"):
        # rwkv time-mix projections are plain (D, D) matrices, not the
        # attention-shaped (D, H, Dh) tensors sharing their names
        rule = P(DATA, MODEL)
    else:
        key = f"moe_{name}" if in_moe and f"moe_{name}" in _PARAM_RULES \
            else name
        rule = _PARAM_RULES.get(key)
    if rule is None:
        return None
    padded = []
    for r in (rule if isinstance(rule, list) else [rule]):
        trailing = len(r)
        if rank < trailing:
            r = P(DATA, MODEL) if rank == 2 else P(*([None] * rank))
            trailing = len(r)
        padded.append(P(*([None] * (rank - trailing) + list(r))))
    return padded


def _sub_fsdp(spec, fsdp) -> P:
    """Replace the symbolic DATA (FSDP) axis with the chosen axis tuple:
    (POD, DATA) extends parameter/optimizer sharding across pods; ()
    disables FSDP (replicated-params serving)."""
    out = []
    for e in spec:
        if e == DATA:
            out.append(None if not fsdp else
                       (fsdp if len(fsdp) > 1 else fsdp[0]))
        else:
            out.append(e)
    return P(*out)


def param_specs(cfg, params: dict, mesh, fsdp_axes=(DATA,)) -> dict:
    """{name: Spec} for the port's parameters ``params`` {name: tensor or
    shape}: JAX's spec for each one's JAX leaf, stack dims dropped."""
    fsdp = tuple(a for a in fsdp_axes if a in axis_sizes(mesh))
    paths = jax_leaf_paths(cfg)
    out = {}
    for name, p in params.items():
        shape = tuple(p.shape) if hasattr(p, "shape") else tuple(p)
        path, stack = paths[name]
        jshape = (1,) * stack + shape     # stack dims are never sharded
        cands = _rule_for(path, len(jshape))
        if cands is None:
            out[name] = P(*([None] * len(shape)))
            continue
        spec = best_spec([_sub_fsdp(c, fsdp) for c in cands], jshape, mesh)
        # an axis of size 1 on a stack dim (JAX shards its stacked leaf
        # there) lays nothing out
        sizes = axis_sizes(mesh)
        if any(sizes[a] > 1 for e in spec[:stack] for a in _axes(e)):
            raise AssertionError(f"{name}: a stack dim is sharded: {spec}")
        out[name] = P(*spec[stack:])
    return out


def param_placements(cfg, params: dict, mesh, fsdp_axes=(DATA,)) -> dict:
    """{name: DTensor placements} on ``mesh`` (a ``DeviceMesh``)."""
    return {n: placements(s, mesh) for n, s in
            param_specs(cfg, params, mesh, fsdp_axes).items()}


def batch_axes(mesh):
    return (POD, DATA) if POD in axis_sizes(mesh) else (DATA,)


def activation_rules(mesh, *, shard_residual: bool = False) -> dict:
    """Logical-name → spec map consumed by ``sharding.logical.shard``.

    ``shard_residual``: additionally shard the residual stream's d_model
    over the model axis (ZeRO-R style activation sharding)."""
    dp = batch_axes(mesh)
    res = MODEL if shard_residual else None
    return {
        "act_btd": P(dp, None, res),
        "act_btf": P(dp, None, MODEL),
        "act_bshd": P(dp, None, MODEL, None),
        "act_bti": P(dp, None, MODEL),
        "logits": P(dp, None, MODEL),
        "cache": P(dp, MODEL, None, None),      # seq-sharded KV cache
        "cache_mla": P(dp, MODEL, None),
        "moe_gtd": P(dp, None, None),           # (groups, group_size, D)
        # (groups, experts, capacity, feat): EP over experts, falling back
        # to TP over the expert-FFN dim when n_experts doesn't divide.
        "moe_ecd": P(dp, MODEL, None, None),
        "moe_ecf": [P(dp, MODEL, None, None), P(dp, None, None, MODEL)],
    }


def data_specs(mesh) -> dict:
    """Input-batch specs (keyed by input name)."""
    dp = batch_axes(mesh)
    return {
        "tokens": P(dp, None),
        "labels": P(dp, None),
        "mask": P(dp, None),
        "patches": P(dp, None, None),
        "frames": P(dp, None, None),
    }


def _cache_rule(name: str, dp):
    if name in ("k", "v"):          # (stack.., B, S, KV, Dh)
        return P(dp, MODEL, None, None)
    if name in ("ckv", "krope"):
        return P(dp, MODEL, None)
    if name in ("ssm", "wkv"):      # (.., B, H, P, N)
        return P(dp, MODEL, None, None)
    if name == "conv":              # (.., B, K-1, Cc)
        return P(dp, None, MODEL)
    if name in ("shift_t", "shift_c"):
        return P(dp, None)
    return P()


def cache_shardings(caches, cfg, mesh):
    """Specs for serving state (the tree of ``init_caches``, stacked over
    the layers as JAX's): batch over the data axes; attention-cache seq
    (or MLA latent seq) over model; SSM/WKV states over heads."""
    dp = batch_axes(mesh)

    def one(name, leaf):
        shape = tuple(leaf.shape)
        rule = _cache_rule(name, dp)
        rule = P(*([None] * (len(shape) - len(rule)) + list(rule)))
        return sanitize_spec(rule, shape, mesh)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else one(k, v)
                for k, v in tree.items()}
    return walk(caches)
