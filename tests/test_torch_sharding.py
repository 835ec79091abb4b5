"""The port's sharded layer against the JAX package's: the debug meshes'
shapes, ``sanitize_spec``, every parameter's partition spec for all ten
architectures at full size on both production meshes (the JAX spec of
its JAX leaf, stack dims dropped), the activation, data and cache rules,
and the per-device bytes of the train state; specs as DTensor
placements; the elastic ``Checkpointer.restore(placements=)`` and
``launch.train --mesh debug`` on 4 gloo ranks. JAX's side needs no
devices (``jax.sharding.AbstractMesh``); each torch.distributed world
runs in a subprocess of its own."""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jax_get_config
from repro.launch.dryrun import _make_opt as jax_make_opt
from repro.models import init_caches as jax_init_caches
from repro.models import init_model as jax_init_model
from repro.sharding import partition_specs as jps
from repro.sharding.logical import sanitize_spec as jax_sanitize
from repro.train.train_step import init_train_state as jax_init_state
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.policies import TRAIN_LOWMEM, TRAIN_V_BF16
from repro_torch.launch.train import main as train_main
from repro_torch.models.convert import jax_leaf_paths
from repro_torch.models.transformer import init_caches
from repro_torch.sharding import partition_specs as ps
from repro_torch.sharding.logical import (AbstractMesh, Spec, local_shape,
                                          placements, sanitize_spec)
from repro_torch.train.train_step import skeleton

from _hypothesis_compat import given, settings, st
from _torch_dist import gloo_world, run

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
FSDP = [("data",), ("pod", "data"), ()]


def _meshes(shape, names):
    return AbstractMesh(shape, names), JaxMesh(shape, names)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _spec(jspec, rank):
    """A JAX PartitionSpec as a tuple of ``rank`` entries."""
    t = tuple(jspec)
    return t + (None,) * (rank - len(t))


def test_debug_mesh_shapes_match_jax():
    """n = 1..16, with and without pod=: the shape rule, and the meshes
    ``make_debug_mesh`` builds over a fake world of 16 ranks, against
    JAX's function on 16 host devices (one subprocess)."""
    out = run([sys.executable, "-c", """
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
from repro.launch.mesh import make_debug_mesh as jax_mesh
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import debug_mesh_shape, make_debug_mesh
dryrun.ensure_fake_world(16)
rows = []
for n in range(1, 17):
    for pod in (False, True):
        j = jax_mesh(n, pod=pod)
        m = make_debug_mesh(n, pod=pod)
        rows.append([n, pod, list(j.shape.values()), list(j.axis_names),
                     list(m.shape), list(m.mesh_dim_names),
                     list(debug_mesh_shape(n, pod=pod)[0]),
                     m.mesh.flatten().tolist()])
print(json.dumps(rows))
"""])
    rows = json.loads(out.strip().splitlines()[-1])
    assert len(rows) == 32
    for n, pod, jshape, jnames, tshape, tnames, rule, ranks in rows:
        assert tshape == jshape == rule, (n, pod)
        assert tnames == jnames, (n, pod)
        assert ranks == list(range(n))


@settings(max_examples=60, deadline=None)
@given(st.data())
def test_sanitize_spec_matches_jax(data):
    shape_mesh, names = data.draw(st.sampled_from(MESHES))
    tm, jm = _meshes(shape_mesh, names)
    rank = data.draw(st.integers(1, 4))
    shape = tuple(data.draw(st.lists(st.sampled_from(
        [1, 2, 3, 8, 16, 24, 32, 48, 60, 256, 512]), min_size=rank,
        max_size=rank)))
    entry = st.one_of(st.none(), st.sampled_from(names),
                      st.sampled_from([("pod", "data"), ("data", "model"),
                                       ("pod", "model")]))
    spec = data.draw(st.lists(entry, min_size=rank, max_size=rank))
    spec = [e for e in spec]
    if any(isinstance(e, tuple) and not set(e) <= set(names)
           for e in spec):
        spec = [None if isinstance(e, tuple) and not set(e) <= set(names)
                else e for e in spec]
    got = sanitize_spec(Spec(*spec), shape, tm)
    want = jax_sanitize(JP(*spec), shape, jm)
    assert tuple(got) == _spec(want, len(got))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch):
    """Every parameter of the full-size model: the port's spec is JAX's
    spec for its JAX leaf with the stack dims dropped, on (16, 16) and
    (2, 16, 16), with FSDP over ("data",), ("pod", "data") and ()."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    shapes = jax.eval_shape(lambda k: jax_init_model(jcfg, k),
                            jax.random.PRNGKey(0))
    params = {n: tuple(p.shape) for n, p in
              skeleton(cfg).named_parameters()}
    paths = jax_leaf_paths(cfg)
    assert set(paths) == set(params)
    for shape, names in MESHES:
        tm, jm = _meshes(shape, names)
        for fsdp in FSDP:
            jspecs = jps.param_specs(shapes, jm, fsdp)
            got = ps.param_specs(cfg, params, tm, fsdp)
            for n, (path, stack) in paths.items():
                leaf = _leaf(shapes, path)
                assert leaf.shape[stack:] == params[n], n
                want = _spec(_leaf(jspecs, path), leaf.ndim)
                assert want[:stack] == (None,) * stack
                assert tuple(got[n]) == want[stack:], (n, shape, fsdp)


def _rules_as_tuples(rules):
    """Entries as JAX's PartitionSpec normalises them: ("data",) is
    "data"."""
    def norm(spec):
        return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                     for e in spec)

    def one(r):
        if isinstance(r, list):
            return [norm(x) for x in r]
        return norm(r)
    return {k: one(v) for k, v in rules.items()}


def test_activation_and_data_rules_match_jax():
    for shape, names in MESHES:
        tm, jm = _meshes(shape, names)
        assert ps.batch_axes(tm) == jps.batch_axes(jm)
        for res in (False, True):
            assert _rules_as_tuples(ps.activation_rules(
                tm, shard_residual=res)) == _rules_as_tuples(
                jps.activation_rules(jm, shard_residual=res))
        assert _rules_as_tuples(ps.data_specs(tm)) == _rules_as_tuples(
            jps.data_specs(jm))


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "hubert-xlarge"])
def test_cache_specs_match_jax(arch):
    """The serving caches of a (B 32, S 32768) cell; zamba2's Mamba
    caches stack (groups, period) in JAX and the layers in the port, so
    specs are compared on the trailing dims."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    jc = jax.eval_shape(lambda: jax_init_caches(jcfg, 32, 32768,
                                                dtype=jnp.bfloat16))
    tc = init_caches(cfg, 32, 32768, dtype=torch.bfloat16, device="meta")
    for shape, names in MESHES:
        tm, jm = _meshes(shape, names)
        got = _flat(ps.cache_shardings(tc, cfg, tm))
        want = _flat(jps.cache_shardings(jc, jcfg, jm))
        jshape = _flat(jc)
        assert set(got) == set(want)
        for k, spec in got.items():
            w = _spec(want[k].spec, len(jshape[k].shape))
            assert w[:len(w) - len(spec)] == (None,) * (len(w) - len(spec))
            assert tuple(spec) == w[len(w) - len(spec):], (k, shape)


def _dtype_bytes(dt) -> int:
    return jnp.dtype(dt).itemsize


@pytest.mark.parametrize("arch", ARCHS)
def test_state_bytes_per_device_match_jax(arch):
    """Per-device bytes of the train state's parameters and Adam moments
    (the policies' dtypes, FSDP over ("pod", "data") for the largest
    models): the port's specs and dtypes against JAX's."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    fsdp = ("pod", "data") if arch in TRAIN_LOWMEM else ("data",)
    jstate = jax.eval_shape(lambda k: jax_init_state(
        jax_init_model(jcfg, k), jax_make_opt(arch)), jax.random.PRNGKey(0))
    params = dict(skeleton(cfg).named_parameters())
    m_dt = torch.bfloat16 if arch in TRAIN_LOWMEM else torch.float32
    v_dt = torch.bfloat16 if arch in TRAIN_V_BF16 else torch.float32
    for shape, names in MESHES:
        tm, jm = _meshes(shape, names)
        specs = ps.param_specs(cfg, params, tm, fsdp)
        got = sum(int(np.prod(local_shape(p.shape, specs[n], tm)))
                  * (p.element_size() + m_dt.itemsize + v_dt.itemsize)
                  for n, p in params.items())
        want = 0
        for tree in (jstate["params"], jstate["opt"]["m"],
                     jstate["opt"]["v"]):
            js = jps.param_specs(tree, jm, fsdp)
            for leaf, sp in zip(jax.tree.leaves(tree), jax.tree.leaves(
                    js, is_leaf=lambda x: isinstance(x, JP))):
                loc = local_shape(leaf.shape, _spec(sp, leaf.ndim), tm)
                want += int(np.prod(loc)) * _dtype_bytes(leaf.dtype)
        assert got == want, (shape, got, want)


def test_spec_placements():
    from torch.distributed.tensor import Replicate, Shard

    m = AbstractMesh((2, 4, 1), ("pod", "data", "model"))
    assert placements(Spec(("pod", "data"), None), m) == [
        Shard(0), Shard(0), Replicate()]
    # a size-1 axis is the same layout as replication
    assert placements(Spec(None, "model"), m) == [Replicate()] * 3
    assert placements(Spec("data", "pod"), m) == [Shard(1), Shard(0),
                                                  Replicate()]
    with pytest.raises(ValueError, match="out of the mesh's order"):
        placements(Spec(("data", "pod")), m)
    with pytest.raises(ValueError, match="shards two dims"):
        placements(Spec("data", "data"), m)
    assert local_shape((8, 12), Spec(("pod", "data"), None), m) == (1, 12)


_RESTORE = """
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.sharding.logical import Spec, placements


def work(rank, n, out):
    mesh = make_debug_mesh()
    assert tuple(mesh.shape) == (2, 2)
    g = torch.Generator().manual_seed(0)
    state = {"params": {"w": torch.randn(8, 6, generator=g),
                        "b": torch.randn(4, generator=g).bfloat16()},
             "step": torch.tensor(7, dtype=torch.int32)}
    ck = Checkpointer(f"{out}/ck")
    if rank == 0:
        ck.save(state, 3)
    dist.barrier()
    specs = {"w": Spec("data", "model"), "b": Spec(("data", "model"))}
    pl = {"params": {k: placements(s, mesh) for k, s in specs.items()}}
    got, step = ck.restore(placements=pl, mesh=mesh)
    assert step == 3 and int(got["step"]) == 7
    d, m = mesh.get_coordinate()
    w = got["params"]["w"]
    assert tuple(w.shape) == (8, 6)
    assert torch.equal(w.to_local(),
                       state["params"]["w"][4 * d:4 * d + 4, 3 * m:3 * m + 3])
    b = got["params"]["b"]
    assert b.dtype == torch.bfloat16
    assert torch.equal(b.to_local(), state["params"]["b"][2 * d + m:][:1])
    print("ok", rank)
"""


def test_restore_placements_on_a_gloo_mesh(tmp_path):
    """The elastic path: a checkpoint of whole tensors restored onto a
    (2, 2) mesh of 4 gloo ranks; each local shard is its slice."""
    assert "ok 0" in gloo_world(4, _RESTORE, tmp_path)


def _losses(stdout: str) -> list:
    line = [ln for ln in stdout.splitlines() if ln.startswith(
        "[train] losses")][-1]
    return json.loads(line.split("losses", 1)[1])


def test_train_mesh_debug_matches_meshless(tmp_path):
    """``launch.train --mesh debug`` on 4 gloo ranks ((2, 2): FSDP over
    data × TP over model), reduced smollm in f32, 3 steps: the losses of
    the one-device trainer with the same seed (f32: bf16 rounds the
    tensor-parallel partial sums differently)."""
    args = ["-m", "repro_torch.launch.train", "--arch", "smollm-360m",
            "--reduced", "--dtype", "float32", "--steps", "3", "--batch",
            "8", "--seq", "32", "--device", "cpu", "--log-every", "1"]
    from _torch_dist import free_port
    mesh_out = run([sys.executable, "-m", "torch.distributed.run",
                    "--nproc-per-node=4", f"--master-port={free_port()}",
                    *args, "--mesh", "debug"])
    assert "on mesh {'data': 2, 'model': 2} (4 cpu ranks)" in mesh_out
    report = train_main(args[2:])
    plain, got = report.losses, _losses(mesh_out)
    assert len(got) == len(plain) == 3
    np.testing.assert_allclose(got, plain, rtol=1e-5)


_GRADS = """
import json

import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get_config
from repro_torch.data.pipeline import make_pipeline
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import init_model
from repro_torch.sharding.logical import placements, sanitize_spec, use_rules
from repro_torch.sharding.partition_specs import (activation_rules,
                                                  data_specs,
                                                  param_placements)
from repro_torch.train.train_step import grads_of, to_device

ARCHS = {archs!r}


def work(rank, n, out):
    mesh = make_debug_mesh()
    result = {{}}
    for arch in ARCHS:
        cfg = get_config(arch, reduced=True).replace(
            dtype="float32", param_dtype="float32")
        params = dict(init_model(cfg, seed=0, device="cpu",
                                 train=True).named_parameters())
        batch = to_device(make_pipeline(cfg, dict(
            seq_len=32, global_batch=8), seed=0).at(0), "cpu")
        want, wm = grads_of(cfg, params, batch)
        pl = param_placements(cfg, params, mesh)
        dparams = {{k: distribute_tensor(p.detach(), mesh, pl[k],
                                        src_data_rank=None)
                   for k, p in params.items()}}
        ds = data_specs(mesh)
        dbatch = {{k: distribute_tensor(
            t, mesh, placements(sanitize_spec(ds[k], t.shape, mesh), mesh),
            src_data_rank=None) for k, t in batch.items()}}
        with use_rules(mesh, activation_rules(mesh)), implicit_replication():
            got, gm = grads_of(cfg, dparams, dbatch)
        loss = gm["loss"].full_tensor().item()
        worst = 0.0
        for k, g in want.items():
            d = (got[k].full_tensor() - g).abs().max().item()
            worst = max(worst, d / max(g.abs().max().item(), 1e-30))
        result[arch] = [loss, wm["loss"].item(), worst]
    if rank == 0:
        print(json.dumps(result))
"""
MESH_GRAD_ARCHS = ("mixtral-8x22b", "minicpm3-4b", "rwkv6-3b",
                   "zamba2-2.7b")


@pytest.fixture(scope="module")
def mesh_grads(tmp_path_factory):
    out = gloo_world(4, _GRADS.format(archs=MESH_GRAD_ARCHS),
                     tmp_path_factory.mktemp("grads"))
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", MESH_GRAD_ARCHS)
def test_loss_and_gradients_on_a_gloo_mesh(mesh_grads, arch):
    """The reduced model in f32 on a (2, 2) mesh of 4 gloo ranks (FSDP ×
    TP; the MoE experts, MLA, RWKV-6 and Mamba-2 regions):
    the loss and every parameter's gradient equal one device's at 1e-5
    (of the gradient's scale): a region's replicated inputs take partial
    gradients."""
    loss, want, worst = mesh_grads[arch]
    np.testing.assert_allclose(loss, want, rtol=1e-5)
    assert worst <= 1e-5, worst
