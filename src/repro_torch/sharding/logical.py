"""Logical-axis sharding (the port of the JAX package's
``sharding/logical.py``): models annotate activations by *name*; the
runtime maps names to specs for the current mesh. Outside a mesh context,
or on a plain tensor, the hints are the identity, so model code runs
unchanged on one device.

A ``Spec`` is the port's ``PartitionSpec``: one entry per tensor dim,
``None``, a mesh axis name, or a tuple of names. ``placements(spec,
mesh)`` turns it into DTensor placements. DTensor shards one tensor dim
over several mesh dims in mesh-dim order, the first one outermost; JAX's
``("pod", "data")`` is the same order, and a spec whose axes on one dim
are out of mesh order raises. Specs are sanitised against the concrete
shape before they become placements, as JAX does: DTensor would accept an
uneven shard where JAX falls back to replication.
"""
from __future__ import annotations

import contextlib
import contextvars
import sys

_RULES: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "logical_rules", default=None)
_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "logical_mesh", default=None)


class Spec(tuple):
    """``Spec("data", None, ("pod", "model"))``: one entry per dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


class AbstractMesh:
    """Axis names and sizes without devices or a process group, for
    specs and byte counts (JAX's ``AbstractMesh``); a ``DeviceMesh``
    serves wherever this does."""

    def __init__(self, shape: tuple, names: tuple):
        if len(shape) != len(names):
            raise ValueError(f"{shape} and {names} differ in length")
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)

    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an ``AbstractMesh``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


@contextlib.contextmanager
def use_rules(mesh, rules: dict | None):
    t1 = _MESH.set(mesh)
    t2 = _RULES.set(rules)
    try:
        yield
    finally:
        _MESH.reset(t1)
        _RULES.reset(t2)


def current_mesh():
    return _MESH.get()


def current_rules() -> dict | None:
    return _RULES.get()


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def sanitize_spec(spec, shape, mesh) -> Spec:
    """Drop mesh axes that do not evenly divide the corresponding dim
    (batch=1 cells, odd head counts and non-divisible vocabs degrade to
    replication on that dim)."""
    sizes = axis_sizes(mesh)
    out = []
    for d, entry in enumerate(spec):
        if entry is None or d >= len(shape):
            out.append(None)
            continue
        keep, size = [], 1
        for a in _axes(entry):
            if shape[d] % (size * sizes[a]) == 0:
                keep.append(a)
                size *= sizes[a]
        out.append(tuple(keep) if len(keep) > 1 else
                   (keep[0] if keep else None))
    return Spec(*out)


def _coverage(spec, mesh) -> int:
    sizes, n = axis_sizes(mesh), 1
    for e in spec:
        for a in _axes(e):
            n *= sizes[a]
    return n


def best_spec(rule, shape, mesh) -> Spec:
    """A rule is a spec or a list of fallback candidates: the candidate
    covering the most devices after sanitisation wins (the first among
    equals)."""
    best, best_cov = None, -1
    for c in (rule if isinstance(rule, list) else [rule]):
        s = sanitize_spec(c, shape, mesh)
        cov = _coverage(s, mesh)
        if cov > best_cov:
            best, best_cov = s, cov
    return best


def placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` where tensor dim d names it, else ``Replicate()``; a
    mesh dim of size 1 is always ``Replicate()`` (the same layout, and
    DTensor reshapes it freely). Sanitise the spec first."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in _axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {entry} of dim {d} are out of "
                             f"the mesh's order {tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: mesh axis {names[i]} shards two "
                                 "dims")
            out[i] = Shard(d)
    return [Replicate() if n == 1 else p
            for n, p in zip(tuple(mesh.shape), out)]


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one device's shard of a tensor of ``shape`` under a
    sanitised ``spec`` (even shards)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            out[d] //= sizes[a]
    return tuple(out)


def is_dtensor(x) -> bool:
    # no DTensor exists before its module is imported: a model off a
    # mesh never imports it
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def shard(x, name: str):
    """Redistribute DTensor ``x`` to the spec registered for logical name
    ``name``; the identity on a plain tensor, outside rules, or for a name
    without a rule. Specs are sanitised against the concrete shape; a
    rule may list fallback candidates (``best_spec``)."""
    rules, mesh = _RULES.get(), _MESH.get()
    if rules is None or mesh is None or not is_dtensor(x):
        return x
    rule = rules.get(name)
    if rule is None:
        return x
    want = placements(best_spec(rule, x.shape, mesh), mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def mesh_of(*xs):
    """The mesh of the first DTensor among ``xs``, else None."""
    for x in xs:
        if is_dtensor(x):
            return x.device_mesh
    return None


def rule(name: str, mesh):
    """The current rules' entry for ``name``, or the default activation
    rules' on ``mesh`` when no rules are active."""
    rules = _RULES.get()
    if rules is None:
        from .partition_specs import activation_rules
        rules = activation_rules(mesh)
    return rules.get(name)


def local_region(fn, mesh, args, in_specs, out_placements):
    """``fn(*local shards)`` through ``local_map``: each tensor of
    ``args`` is redistributed to its spec in ``in_specs`` (a sanitised
    Spec; None for an argument that is not a tensor), ``fn`` runs on the
    local shards, and its outputs become DTensors with
    ``out_placements``. A plain tensor among ``args`` is taken as
    replicated. An input replicated along a mesh dim where an output is
    split gets a partial gradient there (the ranks' shares sum). Used
    where DTensor has no sharding strategy (the kernels' ctypes
    launches) or where its own choices would gather or fail (the
    regions listed in PERF.md §3)."""
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    from torch.distributed.tensor.placement_types import Placement

    rep = [Replicate()] * mesh.ndim
    args = [DTensor.from_local(a, mesh, rep)
            if isinstance(a, torch.Tensor) and not is_dtensor(a) else a
            for a in args]
    in_pl = tuple(None if s is None else tuple(placements(s, mesh))
                  for s in in_specs)
    # An input replicated along a mesh dim over which the work is split
    # (an output sharded or partial there) gets a partial gradient there:
    # each rank's local gradient holds only its share.
    outs = ([out_placements] if isinstance(out_placements[0], Placement)
            else list(out_placements))
    split = [any(o is not None and not isinstance(o[i], Replicate)
                 for o in outs) for i in range(mesh.ndim)]
    grad_pl = tuple(None if pl is None else tuple(
        Partial() if split[i] and isinstance(p, Replicate) else p
        for i, p in enumerate(pl)) for pl in in_pl)
    return local_map(fn, out_placements=out_placements, in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def heads_specs(mesh, *tensors, heads_dim: int = 2):
    """Specs for tensors laid out (batch, ..., heads, ...) entering a
    kernel: the batch over the data axes and the heads over ``model`` as
    the rule ``act_bshd`` gives them, sanitised against each shape. The
    heads of every tensor with more than one head must split alike
    (GQA's groups stay whole), else none is split; a one-head tensor
    (MLA's latent) and None stay whole on ``model``."""
    base = rule("act_bshd", mesh)
    dp, model = base[0], base[2]
    specs = []
    for t in tensors:
        if t is None:
            specs.append(None)
            continue
        ent = [None] * t.dim()
        ent[0] = dp
        if t.shape[heads_dim] > 1:
            ent[heads_dim] = model
        specs.append(sanitize_spec(Spec(*ent), t.shape, mesh))
    split = [s[heads_dim] for s, t in zip(specs, tensors)
             if s is not None and t.shape[heads_dim] > 1]
    if any(e is None for e in split):
        specs = [None if s is None else
                 Spec(*(None if d == heads_dim else e
                        for d, e in enumerate(s))) for s in specs]
    return specs


def spec_of(x) -> Spec:
    """The Spec of DTensor ``x``'s placements (no Partial)."""
    from torch.distributed.tensor import Replicate, Shard

    entries = [[] for _ in range(x.dim())]
    for name, p in zip(x.device_mesh.mesh_dim_names, x.placements):
        if isinstance(p, Shard):
            entries[p.dim].append(name)
        elif not isinstance(p, Replicate):
            raise ValueError(f"{p} has no spec")
    return Spec(*(None if not e else (e[0] if len(e) == 1 else tuple(e))
                  for e in entries))


def fsdp_gather(p):
    """DTensor parameter ``p`` in its compute layout: gathered over every
    mesh axis but ``model`` (the FSDP all-gather; its backward is the
    gradient's reduce-scatter), its tensor-parallel split kept. Anything
    else as it is."""
    if not is_dtensor(p):
        return p
    from torch.distributed.tensor import Replicate

    want = [pl if name == "model" else Replicate()
            for name, pl in zip(p.device_mesh.mesh_dim_names, p.placements)]
    if want == list(p.placements):
        return p
    return p.redistribute(p.device_mesh, want)


@contextlib.contextmanager
def gathered(module, recurse: bool = True):
    """Inside: ``module``'s DTensor parameters (its own only with
    ``recurse=False``) replaced by ``fsdp_gather`` of them; restored on
    exit. Off a mesh it does nothing."""
    mods = list(module.modules()) if recurse else [module]
    saved = [(m, k, p) for m in mods for k, p in m._parameters.items()
             if is_dtensor(p)]
    for m, k, p in saved:
        m._parameters[k] = fsdp_gather(p)
    try:
        yield
    finally:
        for m, k, p in saved:
            m._parameters[k] = p


def gather_dim(x, dim: int):
    """DTensor ``x`` whole along ``dim`` (its shards there all-gathered);
    anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dim %= x.dim()
    want = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
            for p in x.placements]
    return x.redistribute(x.device_mesh, want)


@contextlib.contextmanager
def local_params(module, **tensors):
    """Inside: ``module``'s own parameters named in ``tensors`` replaced
    by them (a ``local_map`` region's local shards), so the module's own
    code runs on the shards; restored on exit."""
    saved = {k: module._parameters[k] for k in tensors}
    module._parameters.update(tensors)
    try:
        yield
    finally:
        module._parameters.update(saved)


def axis_index(mesh, entry) -> tuple[int, int]:
    """(this rank's index, their count) over the mesh axes of the spec
    entry ``entry``, the first one outermost, as ``Shard`` orders the
    shards; (0, 1) for None."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate() or [0] * len(names)
    index, count = 0, 1
    for a in _axes(entry):
        size = mesh.shape[names.index(a)]
        index, count = index * size + coord[names.index(a)], count * size
    return index, count


def split_axis(mesh, *sizes):
    """``model`` if it divides every one of ``sizes`` (heads, a hidden
    width), else None: the tensor-parallel split of a layer."""
    model = rule("act_bshd", mesh)[2]
    ok = all(sanitize_spec(Spec(model), (n,), mesh)[0] is not None
             for n in sizes)
    return model if ok else None


def row_parallel(spec, mesh, axis) -> list:
    """Placements of a row-parallel product's output: ``spec``'s, and a
    partial sum over ``axis`` (the split its inputs were contracted
    over; nothing when None or of size 1)."""
    from torch.distributed.tensor import Partial

    pl = placements(spec, mesh)
    return [Partial() if n == axis and size > 1 else p for n, size, p in
            zip(mesh.mesh_dim_names, tuple(mesh.shape), pl)]
