"""The dry run (the port of the JAX package's ``launch/dryrun.py``): trace
one step of every (architecture × input shape) cell on the production
meshes, with no card and no memory behind it, and cost it per device:
argument, output and temporary bytes, FLOPs, bytes touched and collective
bytes by kind.

JAX lowers and compiles each cell on 256 or 512 virtual XLA devices. The
port runs the step itself, once:
- the world is fake: a ``"fake"`` process group of 256 or 512 ranks in
  this one process (``ensure_fake_world``), so a ``DeviceMesh`` of the
  production shape exists and every collective is a no-op;
- the tensors are fake (``FakeTensorMode``): the parameters, optimizer
  state, batch and caches are DTensors placed by ``partition_specs``
  whose local shards have shapes and no storage (``launch.specs``);
- ``_Counter``, a dispatch mode that DTensor hands its local ops to,
  counts what one rank computes: FLOPs from the local shapes of each
  matmul (``torch.utils.flop_counter``'s formulas), bytes read and
  written by each op that is not a view, the per-device output bytes of
  each functional collective (JAX's definition, ``collective_bytes``),
  and the live bytes of the step's tensors. A ``FlopCounterMode``
  entered around DTensor code would count the global op instead.

``compile_s`` is 0: nothing is compiled; ``lower_s`` is the trace. The
kernels' plain versions run on the fake shards, as JAX's dry run costs
its plain functions. The same ``run_cell`` on a real mesh (gloo, or NCCL
on the card) runs the step on real tensors from a seeded init and
measures its memory (``execute_plan`` on the card).

Run:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Records are written to ``build/dryrun/<mesh>/<arch>__<shape>.json``
(git-ignored). Importing this module touches no process group.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import SHAPE_DEFS, get_config, runnable_cells
from ..kernels import current_kernel_scope
from ..sharding.logical import gather_dim, use_rules
from ..sharding.partition_specs import activation_rules
from ..train import adamw
from .policies import TRAIN_ACCUM, TRAIN_LOWMEM, TRAIN_V_BF16

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun")

# torch's functional collectives → JAX's (XLA's) five kinds
_COLL = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "all_to_all_single": "all-to-all",
         "all_reduce_coalesced": "all-reduce",
         "all_gather_into_tensor_coalesced": "all-gather",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "permute_tensor": "collective-permute"}
_PRIM_DEVICE = torch.ops.prim.device.default


def ensure_fake_world(n: int = 512) -> None:
    """A ``"fake"`` process group of ``n`` ranks in this process (rank 0),
    the counterpart of JAX's ``ensure_virtual_devices``. A fake world of
    another size is replaced; a real one raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if str(dist.get_backend()) != "fake":
            raise RuntimeError("a real process group is initialised; the "
                               "dry run needs the fake world")
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def is_fake_world() -> bool:
    import torch.distributed as dist
    return dist.is_initialized() and str(dist.get_backend()) == "fake"


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    out = []
    for x in (tree if isinstance(tree, (list, tuple)) else [tree]):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(_tensors(x))
        elif isinstance(x, dict):
            out.extend(_tensors(list(x.values())))
    return out


class _Counter(TorchDispatchMode):
    """Counts one rank's work. Ops with a DTensor argument are handed to
    DTensor (``NotImplemented``), which runs them on the local shards
    and dispatches those local ops back here. The global-shape ops
    DTensor runs to propagate shapes are not counted
    (``_skip_propagation``)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.flops_by_op: dict[str, int] = {}
        self.flops_by_scope: dict[str, int] = {}
        self.bytes = 0
        self.coll: dict[str, float] = {}
        self.live = 0
        self.peak = 0
        self.in_propagation = 0

    def _track(self, out):
        for t in _tensors(out):
            if t._base is not None:
                continue
            n = _nbytes(t)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, n)

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if func is _PRIM_DEVICE:             # a metadata query, not work
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.in_propagation:
            return out
        packet = func._overloadpacket
        name = packet.__name__
        if func.namespace == "_c10d_functional":
            kind = _COLL.get(name)
            if kind is not None:
                self.coll[kind] = self.coll.get(kind, 0.0) + sum(
                    _nbytes(t) for t in _tensors(out))
            return out
        if packet in flop_registry:
            f = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += f
            self.flops_by_op[name] = self.flops_by_op.get(name, 0) + f
            scope = current_kernel_scope() or "model"
            self.flops_by_scope[scope] = self.flops_by_scope.get(
                scope, 0) + f
        if not func.is_view and name not in ("detach", "alias"):
            ins = _tensors(list(args) + list(kwargs.values()))
            outs = _tensors(out)
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            inplace = any(o is i for o in outs for i in ins)
            if not inplace:
                self._track(out)
        return out


@contextlib.contextmanager
def _skip_propagation(counter: _Counter):
    """While DTensor propagates shapes (it runs the op on global fake
    tensors), ``counter`` counts nothing."""
    from torch.distributed.tensor import DTensor

    prop = DTensor._op_dispatcher.sharding_propagator
    inner = prop._propagate_tensor_meta_non_cached

    def wrapped(*a, **k):
        counter.in_propagation += 1
        try:
            return inner(*a, **k)
        finally:
            counter.in_propagation -= 1
    prop._propagate_tensor_meta_non_cached = wrapped
    try:
        yield
    finally:
        del prop._propagate_tensor_meta_non_cached


@contextlib.contextmanager
def fake_mode():
    """The dry run's ``FakeTensorMode``: tensors made inside have shapes
    and no storage."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        yield


def _make_opt(arch):
    if arch in TRAIN_LOWMEM:
        v_dt = torch.bfloat16 if arch in TRAIN_V_BF16 else torch.float32
        return adamw(m_dtype=torch.bfloat16, v_dtype=v_dt)
    return adamw()


def _moment_dtypes(arch):
    if arch in TRAIN_LOWMEM:
        return torch.bfloat16, (torch.bfloat16 if arch in TRAIN_V_BF16
                                else torch.float32)
    return torch.float32, torch.float32


def _step_fn(cfg, kind, accum: int = 1, arch: str = ""):
    """The step a cell runs: ``train`` the train step (AdamW of the
    policies, microbatch accumulation); ``prefill`` (params, batch,
    caches) → (logits, caches); ``prefill_encoder`` (params, batch) →
    logits; ``decode`` (params, batch, caches, pos) → (next tokens,
    caches)."""
    from ..models.transformer import forward
    from ..train.train_step import bind, make_train_step, skeleton

    if kind == "train":
        accum_dtype = (torch.bfloat16 if arch in TRAIN_LOWMEM
                       else torch.float32)
        return make_train_step(cfg, _make_opt(arch), accum_steps=accum,
                               accum_dtype=accum_dtype)
    if kind == "prefill":
        def prefill(params, batch, caches):
            model = bind(skeleton(cfg), params)
            return forward(model, batch, mode="prefill", caches=caches)
        return prefill
    if kind == "prefill_encoder":
        def enc(params, batch):
            model = bind(skeleton(cfg), params)
            return forward(model, batch, mode="train")[0]
        return enc
    if kind == "decode":
        def decode(params, batch, caches, pos):
            model = bind(skeleton(cfg), params)
            logits, caches = forward(model, batch, mode="decode",
                                     caches=caches, pos=pos)
            last = gather_dim(logits[:, -1], -1)
            return last[:, :cfg.vocab_size].argmax(-1), caches
        return decode
    raise ValueError(kind)


class Cell:
    """One traced cell: ``run()`` runs ``step(*args)`` under the rules
    and returns its outputs."""

    def __init__(self, step, args, rules, mesh, meta):
        self.step, self.args, self.rules, self.mesh = step, args, rules, mesh
        self.meta = meta

    def run(self):
        from torch.distributed.tensor.experimental import implicit_replication
        with use_rules(self.mesh, self.rules), implicit_replication():
            return self.step(*self.args)


def _cell_kind(cfg, shape):
    kind = SHAPE_DEFS[shape]["kind"]
    if cfg.is_encoder and kind == "prefill":
        kind = "prefill_encoder"
    return kind


def lower_cell(arch: str, shape: str, mesh, *, shard_residual=None,
               extra_rules=None, accum=None, cfg_overrides=None,
               serve_fsdp=None, cfg=None, materialize=None, seed=0):
    """→ (Cell, meta) for one cell on one mesh: the step, its arguments
    placed on the mesh, and the rules. The keyword knobs (sharding rules,
    accumulation, config fields) are JAX's §Perf iteration surface;
    ``cfg=`` substitutes an explicit config (e.g. a reduced one). The
    arguments are fake (``launch.specs``) on the fake world; on a real
    one, or with ``materialize=True``, they are real: the parameters of
    ``init_model(cfg, seed)``, zero moments and caches, token 0, each
    placed by its spec."""
    from .specs import (cache_specs, input_specs, params_specs_only,
                        state_specs)

    if cfg is None:
        cfg = get_config(arch)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    kind = _cell_kind(cfg, shape)
    if shard_residual is None:
        # residual-stream sharding on for training of wide models
        shard_residual = kind == "train" and cfg.d_model >= 2048
    rules = activation_rules(mesh, shard_residual=shard_residual)
    if extra_rules:
        rules.update(extra_rules)
    # ≥100B models extend FSDP across pods (their state exceeds one pod).
    fsdp = ("pod", "data") if arch in TRAIN_LOWMEM else ("data",)
    if serve_fsdp is not None and kind != "train":
        fsdp = serve_fsdp            # e.g. () = replicated-params serving
    n_accum = accum if accum is not None else TRAIN_ACCUM.get(arch, 1)
    real = (not is_fake_world()) if materialize is None else materialize
    step = _step_fn(cfg, kind, n_accum, arch)
    if kind == "train":
        state, _ = state_specs(cfg, mesh, *_moment_dtypes(arch),
                               fsdp_axes=fsdp)
        if real:
            state = _materialize_state(cfg, state, seed)
        args = (state, _inputs(cfg, shape, mesh, real))
    else:
        params, _ = params_specs_only(cfg, mesh, fsdp)
        if real:
            params = _materialize_params(cfg, params, seed)
        args = (params, _inputs(cfg, shape, mesh, real))
        if kind != "prefill_encoder":
            caches, _ = cache_specs(cfg, shape, mesh)
            args += (_fill(caches, real),)
        if kind == "decode":
            args += (SHAPE_DEFS[shape]["seq_len"] - 1,)
    meta = {"arch": arch, "shape": shape, "kind": kind, "cfg": cfg,
            "accum": n_accum, "real": real}
    return Cell(step, args, rules, mesh, meta), meta


def _inputs(cfg, shape, mesh, real):
    from .specs import input_specs
    return _fill(input_specs(cfg, shape, mesh), real)


def _fill(tree, real):
    """Real arguments are zero-filled in place (their ``torch.empty``
    holds garbage); fake ones are left as they are."""
    if real:
        with torch.no_grad():
            for t in _tensors(tree):
                t.zero_()
    return tree


def _materialize_params(cfg, params, seed):
    """The seeded init, each leaf placed like its fake counterpart."""
    from torch.distributed.tensor import distribute_tensor

    from ..models.transformer import init_model
    dev = params[next(iter(params))].device_mesh.device_type
    model = init_model(cfg, seed=seed, device=dev, train=True)
    out = {}
    for n, p in model.named_parameters():
        want = params[n]
        # every rank draws the same weights and keeps its shard
        out[n] = distribute_tensor(p.detach(), want.device_mesh,
                                   want.placements, src_data_rank=None)
    del model
    return out


def _materialize_state(cfg, state, seed):
    params = _materialize_params(cfg, state["params"], seed)
    opt = state["opt"]
    _fill([opt["m"], opt["v"], opt["count"], state["step"]], True)
    return {"params": params, "opt": opt, "step": state["step"]}


def _local(t):
    from ..sharding.logical import is_dtensor
    return t.to_local() if is_dtensor(t) else t


def _storages(args) -> set:
    return {_local(t).untyped_storage()._cdata for t in _tensors(list(args))}


def _arg_bytes(args, skip=frozenset()) -> int:
    """Local (per-device) bytes of every tensor of ``args``, but those
    whose storage is in ``skip``."""
    return sum(_nbytes(_local(t)) for t in _tensors(list(args))
               if _local(t).untyped_storage()._cdata not in skip)


def _requested(which: str = "current") -> int:
    """The bytes the program has requested of the caching allocator: a
    cached block it reuses whole for a smaller tensor is not counted
    beyond the tensor's bytes, as ``memory_allocated`` would."""
    return torch.cuda.memory_stats()[f"requested_bytes.all.{which}"]


def count(fn):
    """Run ``fn()`` under a fresh ``_Counter`` → (its output, the
    counter)."""
    counter = _Counter()
    with _skip_propagation(counter), counter:
        out = fn()
    return out, counter


def run_cell(arch: str, shape: str, mesh_name: str, mesh,
             calibrate: bool = False, **knobs) -> dict:
    """Trace (fake world) or run (real mesh) one cell and cost it per
    device → JAX's record keys, plus ``flops_by_op`` and
    ``kernel_flops_per_device`` (the kernels' plain versions' share) and,
    on a real mesh, the measured memory under ``measured`` (requested
    bytes: the arguments' after the set-up, the step's peak). Memory per
    device: the arguments' local bytes, the outputs' (caches updated in
    place among them), and as temp the peak of the bytes the step's ops
    had alive at once less the new outputs' (views are not tracked)."""
    import torch.distributed as dist

    fake = is_fake_world() and not knobs.get("materialize")
    ctx = fake_mode() if fake else contextlib.nullcontext()
    cuda = mesh.device_type == "cuda"
    if cuda:
        gc.collect()
        torch.cuda.synchronize()
        base = _requested()
    with ctx:
        t0 = time.time()
        cell, meta = lower_cell(arch, shape, mesh, **knobs)
        if cuda:
            gc.collect()            # the init's discarded tensors
            torch.cuda.synchronize()
            args_alloc = _requested() - base
            torch.cuda.reset_peak_memory_stats()
        out, c = count(cell.run)
        if cuda:
            torch.cuda.synchronize()
        t_trace = time.time() - t0
        arg_b = _arg_bytes(cell.args)
        outs = out if isinstance(out, tuple) else (out,)
        out_b = _arg_bytes(outs)
        # outputs the step allocated (not its arguments, updated in place)
        new_b = _arg_bytes(outs, skip=_storages(cell.args))
    rec = {
        "arch": arch,
        "shape": shape,
        "mesh": mesh_name,
        "kind": meta["kind"],
        "n_devices": dist.get_world_size(),
        "lower_s": round(t_trace, 2),
        "compile_s": 0.0,
        "memory": {"argument_size_in_bytes": arg_b,
                   "output_size_in_bytes": out_b,
                   "temp_size_in_bytes": max(c.peak - new_b, 0)},
        "flops_per_device": float(c.flops),
        "bytes_per_device": float(c.bytes),
        "collective_bytes_per_device": dict(c.coll),
        "flops_by_op": dict(c.flops_by_op),
        "kernel_flops_per_device": {k: v for k, v in
                                    c.flops_by_scope.items()
                                    if k != "model"},
    }
    if cuda:
        rec["measured"] = {
            "argument_bytes_allocated": int(args_alloc),
            "peak_bytes_allocated": int(_requested("peak") - base)}
    if calibrate:
        rec["calibrated"] = calibrate_cell(arch, shape, mesh, **knobs)
    return rec


def perf_knobs(arch: str, shape: str) -> dict:
    """The beyond-paper layout changes JAX's EXPERIMENTS.md §Perf
    adopted."""
    from ..sharding.logical import Spec
    kind = SHAPE_DEFS[shape]["kind"]
    knobs: dict = {}
    if kind in ("prefill", "decode"):
        # replicated-params serving, whenever the TP-sharded bf16 params
        # fit comfortably (all but deepseek)
        if arch != "deepseek-v2-236b":
            knobs["serve_fsdp"] = ()
    if arch == "internlm2-20b" and kind == "train":
        knobs["shard_residual"] = False      # no ZeRO-R
        knobs["accum"] = 8
    if arch == "minicpm3-4b" and kind == "prefill":
        knobs["extra_rules"] = {"attn_qchunk": Spec(("data",), "model",
                                                    None, None, None)}
    return knobs


def execute_plan(plan_result, arch: str, shape: str, mesh,
                 mesh_name: str = "plan", *, calibrate: bool = False,
                 cfg=None, cfg_overrides=None, extra_rules=None,
                 **extra_knobs) -> dict:
    """Trace and cost the layout a ``sharding/mcm_planner`` plan chose
    (on the fake world), or run it (on a real mesh): the planner's knobs
    (residual-stream sharding, microbatch accumulation) become dry-run
    knobs. Returns a ``run_cell`` record with a ``plan`` section holding
    the analytical prediction beside the measured cost."""
    knobs = plan_result.to_dryrun_knobs()
    knobs.update(extra_knobs)
    rec = run_cell(arch, shape, mesh_name, mesh, calibrate=calibrate,
                   cfg=cfg, cfg_overrides=cfg_overrides,
                   extra_rules=extra_rules, **knobs)
    rec["plan"] = {
        "arch": plan_result.arch,
        "baseline_latency_s": float(plan_result.baseline_latency),
        "optimized_latency_s": float(plan_result.optimized_latency),
        "modeled_speedup": float(plan_result.modeled_speedup),
        "nonuniform_headroom": float(plan_result.nonuniform_headroom),
        "redist_mask": [int(b) for b in plan_result.redist_mask],
        "knobs": {k: v for k, v in knobs.items()},
    }
    return rec


def _calib_layers(cfg) -> tuple[int, int, float, float, float]:
    """(L1, L2, units1, units2, units_full) for per-unit extrapolation."""
    if cfg.family == "hybrid":
        p = cfg.hybrid_attn_period
        return p, 2 * p, 1, 2, cfg.n_layers / p
    if cfg.local_global_period:
        p = cfg.local_global_period
        return p, 2 * p, 1, 2, cfg.n_layers / p
    if cfg.first_dense_layers:
        d = cfg.first_dense_layers
        return d + 1, d + 2, 1, 2, cfg.n_layers - d
    return 1, 2, 1, 2, cfg.n_layers


def calibrate_cell(arch: str, shape: str, mesh, *, extra_rules=None,
                   accum=None, shard_residual=None, cfg_overrides=None,
                   serve_fsdp=None, cfg=None, **_) -> dict:
    """JAX's per-unit extrapolation: trace two shallow configs (L1, L2
    repeating units; for a train cell at accumulation 1 and 2) and
    extrapolate per unit to full depth (bilinearly in layers × accum for
    training). JAX needs it because XLA counts a ``while`` body once
    (``kernels/calibrate.py``); the port's trace counts every trip, so
    its full-depth record is exact and this is a cheaper estimate of it
    (``tests/test_torch_dryrun.py`` holds the two equal). Sequence
    scaling of long SSM/hybrid cells is JAX's too."""
    base = cfg if cfg is not None else get_config(arch)
    if cfg_overrides:
        base = base.replace(**cfg_overrides)
    L1, L2, u1, u2, uf = _calib_layers(base)
    sd = SHAPE_DEFS[shape]
    shape_used, seq_scale = shape, 1.0
    if (base.family in ("ssm", "hybrid") and sd["kind"] != "decode"
            and sd["seq_len"] > 8192):
        shape_used = f"__calib_{shape}"
        SHAPE_DEFS[shape_used] = dict(sd, seq_len=4096)
        seq_scale = sd["seq_len"] / 4096.0
    af = accum if accum is not None else TRAIN_ACCUM.get(arch, 1)
    accums = (1, 2) if sd["kind"] == "train" else (None,)
    out = {}
    try:
        for ai, a in enumerate(accums):
            for li, L in enumerate((L1, L2)):
                c = base.replace(n_layers=L)
                with fake_mode():
                    cell, _ = lower_cell(
                        arch, shape_used, mesh, cfg=c,
                        extra_rules=extra_rules, accum=a,
                        shard_residual=shard_residual,
                        serve_fsdp=serve_fsdp, materialize=False)
                    _, k = count(cell.run)
                out[ai, li] = {"flops": float(k.flops),
                               "bytes": float(k.bytes),
                               "coll": dict(k.coll)}
    finally:
        if shape_used != shape:
            SHAPE_DEFS.pop(shape_used, None)

    def field(ai, li, key, ck=None):
        v = out[ai, li][key]
        return v.get(ck, 0.0) if ck is not None else v

    def extra(key, ck=None):
        if len(accums) == 1:
            f1, f2 = field(0, 0, key, ck), field(0, 1, key, ck)
            return (f1 + (f2 - f1) / (u2 - u1) * (uf - u1)) * seq_scale
        # bilinear: f(L, a) = a·(A·L + B) + (C·L + D)
        f11, f12 = field(0, 0, key, ck), field(0, 1, key, ck)  # a=1
        f21, f22 = field(1, 0, key, ck), field(1, 1, key, ck)  # a=2
        dL = u2 - u1
        A = (f22 - f21 - f12 + f11) / dL          # per-layer per-accum
        B = (f21 - f11) - A * u1                  # per-accum base
        C = (f12 - f11) / dL - A                  # per-layer const
        D = f11 - A * u1 - B - C * u1
        val = af * (A * uf + B) + (C * uf + D)
        return max(0.0, val) * seq_scale

    kinds = set()
    for v in out.values():
        kinds |= set(v["coll"])
    return {
        "flops_per_device": extra("flops"),
        "bytes_per_device": extra("bytes"),
        "collective_bytes_per_device": {k: extra("coll", k)
                                        for k in kinds},
        "units": [u1, u2, uf],
        "accum_eval": af,
        "seq_scale": seq_scale,
    }


def save_rec(rec: dict, art_dir: str = ART_DIR) -> str:
    d = os.path.join(art_dir, rec["mesh"])
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{rec['arch']}__{rec['shape']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


MESHES = {"single": ("single_pod_16x16", 256, False),
          "multi": ("multi_pod_2x16x16", 512, True)}


def main(argv=None):
    from .mesh import make_production_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--calibrate", action="store_true",
                    help="add JAX's per-unit extrapolation to each record")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the adopted §Perf layout changes "
                         "(perf_knobs)")
    ap.add_argument("--out", default=ART_DIR)
    args = ap.parse_args(argv)

    cells = runnable_cells()
    if args.arch:
        cells = [c for c in cells if c[0] == args.arch]
    if args.shape:
        cells = [c for c in cells if c[1] == args.shape]
    if not cells or not (args.all or args.arch or args.shape):
        raise SystemExit("no matching cells (name --arch/--shape or --all)")

    names = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    failures = []
    for key in names:
        mesh_name, n, multi = MESHES[key]
        ensure_fake_world(n)
        mesh = make_production_mesh(multi_pod=multi)
        for arch, shape in cells:
            tag = f"{mesh_name} {arch} {shape}"
            path = os.path.join(args.out, mesh_name, f"{arch}__{shape}.json")
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    done = json.load(f)
                if not args.calibrate or "calibrated" in done:
                    print(f"[skip] {tag}")
                    continue
            try:
                knobs = perf_knobs(arch, shape) if args.optimized else {}
                rec = run_cell(arch, shape, mesh_name, mesh,
                               calibrate=args.calibrate, **knobs)
                path = save_rec(rec, args.out)
                m = rec["memory"]
                coll = sum(rec["collective_bytes_per_device"].values())
                print(f"[ok] {tag}: trace={rec['lower_s']}s "
                      f"args={m['argument_size_in_bytes'] / 2**30:.2f}GiB "
                      f"temp={m['temp_size_in_bytes'] / 2**30:.2f}GiB "
                      f"flops/dev={rec['flops_per_device']:.4g} "
                      f"coll/dev={coll:.4g}B "
                      f"-> {path}")
            except Exception as e:  # noqa: BLE001 - report every cell
                failures.append((tag, repr(e)))
                print(f"[FAIL] {tag}: {e!r}")
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e)
        raise SystemExit(1)
    print("\nAll dry-run cells traced.")


if __name__ == "__main__":
    main()
