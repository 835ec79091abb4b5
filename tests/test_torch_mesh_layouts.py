"""The port's mesh layer held to JAX's layouts, on 4 gloo ranks ((2, 2):
data × model) and on a fake world, each in a subprocess of its own
(``tests/_torch_dist.py``):

- the ``attn_qchunk`` rule: the rows of each query chunk split over
  ``model`` (JAX's ``blockwise.py`` sharding point) where the heads do not
  divide it; the prefill logits equal the meshless port's, and the
  attention's counted FLOPs per device halve on (2, 2);
- MoE groups of the global tokens (JAX's ``moe_gtd``) where a rank's
  tokens do not form whole groups: loss and gradients equal one device's;
- microbatches of the global batch (JAX's ``x[:mb·n].reshape(n, mb,
  …)``): one accumulated step equals the one-device step;
- every arch's reduced prefill matmul FLOPs against the ``dot_general``
  FLOPs of JAX's jaxpr of the same step.
"""
import json
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.models.layers.mlp as jax_mlp
from repro.configs import get_config as jax_get_config
from repro.models import forward as jax_forward
from repro.models import init_caches as jax_init_caches
from repro.models import init_model as jax_init_model
from repro_torch.configs import ARCHS

from _torch_dist import gloo_world, run

_GLOO = r"""
import json

import torch
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import SHAPE_DEFS, get_config
from repro_torch.data.pipeline import make_pipeline
from repro_torch.kernels.flash_attention import ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import init_model
from repro_torch.models.transformer import forward, init_caches
from repro_torch.sharding.logical import (Spec, placements, sanitize_spec,
                                          use_rules)
from repro_torch.sharding.partition_specs import (activation_rules,
                                                  data_specs,
                                                  param_placements)
from repro_torch.train.optimizer import adamw
from repro_torch.train.train_step import (accumulated_grads, grads_of,
                                          init_train_state, make_train_step,
                                          microbatches, to_device)

QCHUNK = {"attn_qchunk": Spec(("data",), "model", None, None, None)}


def f32(arch):
    return get_config(arch, reduced=True).replace(dtype="float32",
                                                  param_dtype="float32")


def on_mesh(mesh, tree, pl):
    return {k: distribute_tensor(t.detach(), mesh, pl[k],
                                 src_data_rank=None)
            for k, t in tree.items()}


def place_batch(mesh, batch):
    ds = data_specs(mesh)
    return {k: distribute_tensor(
        t, mesh, placements(sanitize_spec(ds[k], t.shape, mesh), mesh),
        src_data_rank=None) for k, t in batch.items()}


def val(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).item()


def rel(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
            ).item()


def qchunk_prefill(mesh, arch):
    # minicpm3 with 3 heads, smollm's 3 query heads over 1 kv head: they
    # do not divide model (2)
    cfg = f32(arch).replace(n_heads=3)
    SHAPE_DEFS["__qchunk"] = dict(seq_len=64, global_batch=4,
                                  kind="prefill")
    tok = torch.randint(0, cfg.vocab_size, (4, 64),
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = forward(init_model(cfg, seed=0, device="cpu"),
                       {"tokens": tok}, mode="prefill",
                       caches=init_caches(cfg, 4, 64, device="cpu"))[0]
    splits = []
    rows = ops.rows_attention

    def spy(q, k, v, split, **kw):
        splits.append([split.part, split.n, split.c, q.shape[1]])
        return rows(q, k, v, split, **kw)
    ops.rows_attention = spy
    try:
        cell, _ = dryrun.lower_cell(arch, "__qchunk", mesh,
                                    cfg=cfg, extra_rules=QCHUNK,
                                    materialize=True)
        params, batch, caches = cell.args
        batch["tokens"] = distribute_tensor(
            tok, mesh, batch["tokens"].placements, src_data_rank=None)
        with torch.no_grad():
            got = cell.run()[0].full_tensor()
    finally:
        ops.rows_attention = rows
    return {"rel": rel(got, want), "splits": splits}


def qchunk_op(mesh):
    # ops.attention on DTensors under the rule: forward and gradients
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(4, 80, h, 16, generator=g)
               for h in (3, 1, 1))
    w = torch.randn(4, 80, 3, 16, generator=g)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = ops.attention(*plain, window=50, q_chunk=32)
    (want * w).sum().backward()
    dist = [distribute_tensor(t, mesh, placements(Spec("data"), mesh),
                              src_data_rank=None).requires_grad_()
            for t in (q, k, v)]
    with use_rules(mesh, {**activation_rules(mesh), **QCHUNK}):
        got = ops.attention(*dist, window=50, q_chunk=32)
        dw = distribute_tensor(w, mesh, got.placements, src_data_rank=None)
        (got * dw).sum().backward()
    return {"out": rel(got.full_tensor(), want),
            "grads": [rel(d.grad.full_tensor(), p.grad)
                      for d, p in zip(dist, plain)]}


def moe_grads(mesh, batch_rows):
    cfg = f32("mixtral-8x22b")
    params = dict(init_model(cfg, seed=0, device="cpu",
                             train=True).named_parameters())
    batch = to_device(make_pipeline(cfg, dict(
        seq_len=64, global_batch=batch_rows), seed=0).at(0), "cpu")
    want, wm = grads_of(cfg, params, batch)
    dparams = on_mesh(mesh, params, param_placements(cfg, params, mesh))
    with use_rules(mesh, activation_rules(mesh)), implicit_replication():
        got, gm = grads_of(cfg, dparams, place_batch(mesh, batch))
    return {"loss": [val(gm["loss"]), wm["loss"].item()],
            "aux": [val(gm["aux"]), wm["aux"].item()],
            "worst": max(rel(got[k].full_tensor(), g)
                         for k, g in want.items())}


def accum_step(mesh, arch, batch_rows, accum, whole_step):
    # whole_step: also one make_train_step step on both sides
    cfg = f32(arch)
    params = dict(init_model(cfg, seed=0, device="cpu",
                             train=True).named_parameters())
    batch = to_device(make_pipeline(cfg, dict(
        seq_len=64, global_batch=batch_rows), seed=0).at(0), "cpu")
    step = make_train_step(cfg, adamw(), accum_steps=accum)
    want, wm = accumulated_grads(cfg, params, batch, accum)
    if whole_step:
        _, wstep = step(init_train_state(params, adamw()), batch)
    dparams = on_mesh(mesh, params, param_placements(cfg, params, mesh))
    dbatch = place_batch(mesh, batch)
    with use_rules(mesh, activation_rules(mesh)), implicit_replication():
        got, gm = accumulated_grads(cfg, dparams, dbatch, accum)
        if whole_step:
            _, gstep = step(init_train_state(dparams, adamw()), dbatch)
    return {"loss": [val(gm["loss"]), wm["loss"].item()],
            "aux": [val(gm["aux"]), wm["aux"].item()],
            "worst": max(rel(got[k].full_tensor(), g)
                         for k, g in want.items()),
            "step": [[val(gstep[k]), wstep[k].item()]
                     for k in ("loss", "grad_norm")] if whole_step else []}


def batch_gathers(mesh):
    # the microbatches of a batch of two inputs at accum 2 and 4: the
    # collectives they take, and whether they are the one-device rows
    cfg = f32("smollm-360m")
    batch = to_device(make_pipeline(cfg, dict(
        seq_len=64, global_batch=8), seed=0).at(0), "cpu")
    batch["frames"] = torch.randn(8, 64, 4,
                                  generator=torch.Generator().manual_seed(2))
    dbatch = place_batch(mesh, batch)
    out = {}
    for n in (2, 4):
        with CommDebugMode() as comm:
            mbs = microbatches(dbatch, n)
        b = 8 // n
        out[str(n)] = {
            "comm": {str(k): c for k, c in comm.get_comm_counts().items()},
            "inputs": len(batch),
            "rows": all(torch.equal(m[k].full_tensor(), t[i * b:(i + 1) * b])
                        for i, m in enumerate(mbs) for k, t in batch.items()),
            "placements": [str(m[k].placements) for m in mbs[:1]
                           for k in batch]}
    return out


def work(rank, n, out):
    torch.set_num_threads(1)
    mesh = make_debug_mesh()
    result = {"mesh": list(mesh.shape),
              "qchunk": {a: qchunk_prefill(mesh, a)
                         for a in ("minicpm3-4b", "smollm-360m")},
              "qchunk_op": qchunk_op(mesh),
              "moe": {str(b): moe_grads(mesh, b) for b in (6, 8)},
              "gathers": batch_gathers(mesh),
              "accum": {f"{a}/{b}/{k}": accum_step(mesh, a, b, k, b == 6)
                        for a in ("mixtral-8x22b", "smollm-360m")
                        for b, k in ((8, 4), (6, 2))}}
    if rank == 0:
        print(json.dumps(result))
"""

_FAKE = r"""
import json
import logging

from repro_torch.configs import ARCHS, SHAPE_DEFS, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.sharding.logical import Spec

logging.disable(logging.WARNING)
SHAPE_DEFS["__t"] = dict(seq_len=64, global_batch=8, kind="prefill")
out = {"flops": {}, "attention": {}}
dryrun.ensure_fake_world(1)
mesh = make_debug_mesh(1)
for arch in ARCHS:
    rec = dryrun.run_cell(arch, "__t", "t", mesh,
                          cfg=get_config(arch, reduced=True))
    out["flops"][arch] = [rec["flops_by_op"], rec["flops_per_device"]]
cfg = get_config("minicpm3-4b", reduced=True).replace(n_heads=3)
QCHUNK = {"attn_qchunk": Spec(("data",), "model", None, None, None)}


def attention(rules):
    rec = dryrun.run_cell("minicpm3-4b", "__t", "t", mesh, cfg=cfg,
                          extra_rules=rules)
    return rec["kernel_flops_per_device"]["flash_attention"]


out["attention"]["1x1"] = attention(None)
dryrun.ensure_fake_world(4)
mesh = make_debug_mesh(4)
out["attention"]["2x2"] = attention(None)
out["attention"]["2x2 attn_qchunk"] = attention(QCHUNK)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    out = gloo_world(4, _GLOO, tmp_path_factory.mktemp("layouts"),
                     timeout=300)
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def fake():
    stdout = run([sys.executable, "-c", _FAKE], timeout=300)
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ["minicpm3-4b", "smollm-360m"])
def test_attn_qchunk_splits_query_rows_on_a_gloo_mesh(gloo, arch):
    """Reduced minicpm3 (MLA) and smollm (GQA) with 3 query heads (model 2
    does not divide them), B 4 × S 64, f32, under the dry run's
    ``attn_qchunk`` rule: every rank attends its half of each 32-row query
    chunk (two chunks a layer), and the prefill logits equal the meshless
    port's at rtol 1e-5."""
    assert gloo["mesh"] == [2, 2]
    q = gloo["qchunk"][arch]
    assert q["splits"] and all(s[1:] == [2, 32, 64] for s in q["splits"])
    assert {s[0] for s in q["splits"]} <= {0, 1}
    assert q["rel"] <= 1e-5, q["rel"]


def test_attn_qchunk_on_dtensors(gloo):
    """``ops.attention`` on DTensors under the rule (3 query heads over
    one kv head, 80 rows in chunks of 32, the last one ragged, a window of
    50): its output and the gradients of q, k and v equal the plain
    call's at 1e-5."""
    r = gloo["qchunk_op"]
    assert r["out"] <= 1e-5 and max(r["grads"]) <= 1e-5, r


def test_attn_qchunk_halves_attention_flops_per_device(fake):
    """On a fake (2, 2) world the rule halves the attention's counted
    FLOPs per device against the same mesh without it (the batch over
    data already halves them against (1, 1))."""
    a = fake["attention"]
    assert a["2x2"] * 2 == a["1x1"]
    assert a["2x2 attn_qchunk"] * 2 == a["2x2"]


@pytest.mark.parametrize("rows", [6, 8])
def test_moe_global_groups_on_a_gloo_mesh(gloo, rows):
    """Reduced mixtral in f32 at B × S 64 on (2, 2): B 6 is 384 tokens, 192
    a rank, so JAX's two groups of 256 take tokens of both data ranks (one
    group each, as ``moe_gtd`` lays them out); B 8 is 512 tokens, 256 a
    rank, whole groups with JAX's capacity (the global token count says
    whether a group is dropless). Loss, aux loss and every gradient equal
    one device's at 1e-5."""
    m = gloo["moe"][str(rows)]
    np.testing.assert_allclose(*m["loss"], rtol=1e-5)
    np.testing.assert_allclose(*m["aux"], rtol=1e-5)
    assert m["worst"] <= 1e-5, m["worst"]


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "smollm-360m"])
@pytest.mark.parametrize("rows,accum", [(8, 4), (6, 2)])
def test_microbatches_of_the_global_batch(gloo, arch, rows, accum):
    """Accumulation on (2, 2) in f32, S 64 (``accumulated_grads``, the
    train step's): microbatch i is global rows i·mb … (i + 1)·mb − 1 (B 6
    / accum 2: 3 rows, replicated over data), so the accumulated loss, aux
    loss and every gradient equal the one-device trainer's at 1e-5; at B
    6 so do the loss and gradient norm of one whole ``make_train_step``
    step. (The parameters after an AdamW step are not the measure: its
    first update divides each gradient by its own magnitude, which
    carries the summation-order noise of gradients near Adam's eps on to
    ~lr.)"""
    m = gloo["accum"][f"{arch}/{rows}/{accum}"]
    np.testing.assert_allclose(*m["loss"], rtol=1e-5)
    np.testing.assert_allclose(*m["aux"], rtol=1e-5, atol=1e-12)
    assert m["worst"] <= 1e-5, m["worst"]
    for got, want in m["step"]:
        np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("accum", [2, 4])
def test_microbatches_gather_each_input_once(gloo, accum):
    """The microbatches of a batch of two inputs (B 8, over data on (2,
    2)) take one all-gather an input, whatever the accumulation, and no
    other collective; each is the one-device rows, over data again."""
    g = gloo["gathers"][str(accum)]
    assert g["rows"], g
    assert len(g["comm"]) == 1 and "all_gather" in next(iter(g["comm"])), g
    assert sum(g["comm"].values()) == g["inputs"], g
    assert all("Shard(dim=0)" in p for p in g["placements"]), g


def _moe_dispatch_lines() -> set:
    """The lines of JAX's ``moe_apply`` whose einsums multiply one-hot
    tensors (the dispatch and combine tensors, the tokens into the
    experts' slots and the slots back): the port does these as a scatter
    and a gather, index ops with no FLOPs."""
    src = open(jax_mlp.__file__).read().splitlines()
    pat = re.compile(r'^\s*(dispatch|combine|ex_in|out) = .*einsum\(\s*'
                     r'"(gtke,gtkc|gtd,gtec|gecd,gtec)')
    lines = {i + 1 for i, ln in enumerate(src) if pat.search(ln)}
    assert len(lines) == 4, lines
    return lines


def _dot_flops(jaxpr, skip_lines, mult=1) -> int:
    """2·M·N·K of every ``dot_general`` of a jaxpr with a contraction,
    inner jaxprs too (a scan's body times its length), but those at
    ``skip_lines`` of JAX's MoE layer. A ``dot_general`` with no
    contracting dim is an elementwise product (JAX's einsum of three
    operands writes one; the port's einsum multiplies), not a matmul on
    either side."""
    tot = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            frames = [f for f in eqn.source_info.traceback.frames
                      if f.file_name == jax_mlp.__file__]
            moe = frames and frames[0].line_num in skip_lines
            if lc and not moe:
                a = eqn.invars[0].aval.shape
                k = int(np.prod([a[i] for i in lc]))
                tot += 2 * int(np.prod(eqn.outvars[0].aval.shape)) * k * mult
        inner = eqn.params.get("length", 1) if eqn.primitive.name == "scan" \
            else 1
        for p in eqn.params.values():
            for q in (p if isinstance(p, (list, tuple)) else [p]):
                if hasattr(q, "jaxpr") and hasattr(q, "consts"):
                    tot += _dot_flops(q.jaxpr, skip_lines, mult * inner)
                elif type(q).__name__ == "Jaxpr":
                    tot += _dot_flops(q, skip_lines, mult * inner)
    return tot


def _jax_prefill_flops(arch: str) -> int:
    """JAX's reduced ``forward(mode="prefill")`` of B 8 × S 64 into its
    caches (pixtral's 8 patches among the 64; hubert, an encoder with no
    caches, its whole forward), traced to a jaxpr."""
    c = jax_get_config(arch, reduced=True)
    params = jax.eval_shape(lambda k: jax_init_model(c, k),
                            jax.random.PRNGKey(0))
    B, S = 8, 64
    if c.frontend == "audio_stub":
        batch = {"frames": jax.ShapeDtypeStruct((B, S, c.frontend_dim),
                                                jnp.bfloat16)}
        jp = jax.make_jaxpr(lambda p, b: jax_forward(
            p, c, b, mode="train")[0])(params, batch)
    else:
        st = S - (c.frontend_tokens if c.frontend == "vision_stub" else 0)
        batch = {"tokens": jax.ShapeDtypeStruct((B, st), jnp.int32)}
        if c.frontend == "vision_stub":
            batch["patches"] = jax.ShapeDtypeStruct(
                (B, c.frontend_tokens, c.frontend_dim), jnp.bfloat16)
        caches = jax.eval_shape(lambda: jax_init_caches(
            c, B, S, dtype=jnp.bfloat16))
        jp = jax.make_jaxpr(lambda p, b, cc: jax_forward(
            p, c, b, mode="prefill", caches=cc)[:2])(params, batch, caches)
    return _dot_flops(jp.jaxpr, _moe_dispatch_lines())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matmul_flops_match_jax_jaxpr_every_arch(fake, arch):
    """Reduced config, prefill of B 8 × S 64 on a fake (1, 1) world: the
    port's counted mm/addmm/bmm/baddbmm FLOPs (the frontends' projections
    and the plain kernels' products among them) equal the ``dot_general``
    FLOPs of JAX's jaxpr at rtol 1e-9, with two differences by design
    counted out on JAX's side (ROADMAP C): the MoE layer's one-hot
    dispatch and combine products, which the port does as index ops, and
    elementwise products that JAX's three-operand einsums write as
    ``dot_general``s with no contraction (RWKV-6's intra-chunk A and
    bonus term)."""
    by_op, total = fake["flops"][arch]
    got = sum(v for k, v in by_op.items()
              if k in ("mm", "addmm", "bmm", "baddbmm"))
    assert got == total, by_op
    np.testing.assert_allclose(got, _jax_prefill_flops(arch), rtol=1e-9)
