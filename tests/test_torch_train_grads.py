"""The port's training loss against the JAX package's, parameter by
parameter: ``repro_torch.train.train_step.loss_for`` and its gradient by
autograd against ``jax.value_and_grad`` of
``repro.train.train_step.loss_for`` on the same weights (numpy draws in
the JAX parameter tree → ``from_jax_params``, kept in f32) and the same
batch (the synthetic pipeline, bit for bit the same in both packages).
One case per family branch of ``loss_for``: the reduced smollm (dense),
mixtral (MoE, its aux loss), minicpm3 (MLA: the latent is both key and
value), rwkv6 (WKV-6), zamba2 (SSD and the shared attention block),
hubert (the encoder: labels, the span mask, no shift) and pixtral (the
vision stub: the loss over the tokens after the patches). f32 compute
and f32 weights (mixtral's published param_dtype is bf16), per-block
remat on (the reduced configs turn it off) to differentiate through the
recompute. On the CPU the layers run the kernels' plain versions. Then
three AdamW steps from one JAX ``TrainState`` in both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_model as jax_init_model
from repro.train.optimizer import adamw as jax_adamw
from repro.train.optimizer import cosine_schedule as jax_cosine
from repro.train.train_step import init_train_state as jax_init_train_state
from repro.train.train_step import loss_for as jax_loss_for
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.data.pipeline import make_pipeline
from repro_torch.models import init_model
from repro_torch.models.convert import (from_jax_params, jax_leaf_paths,
                                        jax_ranks, train_state_from_jax)
from repro_torch.train import adamw, cosine_schedule
from repro_torch.train.train_step import (grads_of, make_train_step,
                                          to_device)

ARCHS = ("smollm-360m", "mixtral-8x22b", "minicpm3-4b", "rwkv6-3b",
         "zamba2-2.7b", "hubert-xlarge", "pixtral-12b")
F32 = dict(dtype="float32", param_dtype="float32")
# The JAX suite's f32 model limit: the sums run in other orders.
RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Shapes this small run faster on one intra-op thread than on many,
    and leave the other cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_params(jcfg, seed=0):
    """The JAX parameter tree of ``jcfg`` (its shapes from
    ``jax.eval_shape``, no compile), every leaf drawn from numpy: N(0, 1)
    for the embedding (JAX scales it by √D), N(0, 0.1²) elsewhere (about the
    fan-in scale of JAX's init at these widths)."""
    shapes = jax.eval_shape(lambda k: jax_init_model(jcfg, k),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return {k: jax.tree.map(lambda s, std=(1.0 if k == "embed" else 0.1):
                            (std * rng.standard_normal(s.shape)).astype(
                                np.float32), v)
            for k, v in shapes.items()}


def _setup(arch, seq=32, batch=2):
    """The JAX config (remat off: the values are the same, the compile
    shorter), the port's (remat on), the weights, a batch."""
    jcfg = jax_get_config(arch, reduced=True).replace(**F32, remat=False)
    cfg = get_config(arch, reduced=True).replace(**F32, remat=True)
    data = make_pipeline(cfg, dict(seq_len=seq, global_batch=batch),
                         seed=3).at(0)
    return jcfg, cfg, numpy_params(jcfg), data


def jit_run(fn, *args):
    """``jax.jit(fn)(*args)``, compiled at XLA's backend optimisation
    level 0: the values are the same (no fast-math either way), the
    compile a second or so shorter."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return compiled(*args)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    jcfg, cfg, params, data = _setup(arch)
    (jtot, jmet), jgrads = jit_run(jax.value_and_grad(
        lambda p, b: jax_loss_for(jcfg, p, b), has_aux=True),
        params, {k: jnp.asarray(v) for k, v in data.items()})
    port = from_jax_params(cfg, params, torch.float32)
    grads, met = grads_of(cfg, port, to_device(data, "cpu"))

    np.testing.assert_allclose(met["loss"].item(), float(jmet["loss"]),
                               rtol=RTOL)
    np.testing.assert_allclose(met["aux"].item(), float(jmet["aux"]),
                               rtol=RTOL, atol=ATOL)
    if cfg.family == "moe":
        assert met["aux"].item() > 0
    want = from_jax_params(cfg, jax.tree.map(np.asarray, jgrads),
                           torch.float32)
    assert set(want) == set(grads)
    for name, g in want.items():
        assert grads[name].dtype == torch.float32, name
        np.testing.assert_allclose(grads[name].numpy(), g.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    assert max(g.abs().max().item() for g in grads.values()) > 0


# Adam's step is lr·m̂/(√v̂ + ε), of size O(lr) whatever the gradient's: for
# an element whose gradient sits at the level of the f32 noise, the two
# packages' steps differ by up to that. At most this share of a leaf's
# elements may do so, each within 3·lr (three steps).
ADAM_NOISY_SHARE = 1e-3


def assert_adam_close(got, want, what, lr):
    """Every element within RTOL (an element near 0 within RTOL of its
    leaf's scale), but for at most ADAM_NOISY_SHARE of them, within 3·lr."""
    got, want = got.numpy(), want.numpy()
    err = np.abs(got - want)
    limit = RTOL * np.abs(want) + RTOL * np.abs(want).max()
    off = err > limit
    assert off.mean() <= ADAM_NOISY_SHARE, (
        f"{what}: {off.sum()} of {off.size} elements off, max error "
        f"{err.max():.3g}")
    assert err.max() <= 3 * lr, f"{what}: max error {err.max():.3g}"


def test_three_adamw_steps_match_jax():
    """Three AdamW steps (clipping, a cosine schedule with warm-up, bias
    correction) from a JAX ``TrainState`` carried across by
    ``train_state_from_jax``: per-step loss, grad norm and lr, and the
    final params, moments and counts. Without weight decay: JAX's ``p.ndim
    >= 2`` sees its stacked (layers, D) norm scales as matrices and
    decays them, the port's unstacked (D,) scales are exempt
    (``test_adamw_decay_matches_jax_on_one_tree`` holds the decay)."""
    jcfg, cfg, params, _ = _setup("smollm-360m")
    pipe = make_pipeline(cfg, dict(seq_len=32, global_batch=2), seed=5)
    kw = dict(weight_decay=0.0, clip_norm=1.0)
    jopt = jax_adamw(lr=jax_cosine(1e-2, 1, 3), **kw)
    jstate = jax_init_train_state(jax.tree.map(jnp.asarray, params), jopt)
    state = train_state_from_jax(cfg, jax.tree.map(np.asarray, jstate))
    jstep = jax.jit(jax_make_train_step(jcfg, jopt))
    step = make_train_step(cfg, adamw(lr=cosine_schedule(1e-2, 1, 3), **kw))
    for i in range(3):
        batch = pipe.at(i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, batch)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=RTOL,
                                       err_msg=f"step {i} {k}")
    want = train_state_from_jax(cfg, jax.tree.map(np.asarray, jstate))
    assert int(state["step"]) == int(want["step"]) == 3
    assert int(state["opt"]["count"]) == int(want["opt"]["count"]) == 3
    for tree in ("params", "m", "v"):
        got_t = state["params"] if tree == "params" else state["opt"][tree]
        want_t = want["params"] if tree == "params" else want["opt"][tree]
        assert set(got_t) == set(want_t)
        for name, w in want_t.items():
            assert_adam_close(got_t[name], w, f"{tree} {name}", lr=1e-2)


def test_adamw_decay_matches_jax_on_one_tree():
    """Decoupled decay on matrices only, given the same tree to both
    optimizers (a matrix, a vector, a scalar): two updates with clipping
    off and on."""
    rng = np.random.default_rng(4)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "ln": rng.standard_normal(5).astype(np.float32),
              "s": np.full((), 0.7, np.float32)}
    grads = [jax.tree.map(lambda a: np.asarray(
        0.3 * rng.standard_normal(a.shape), np.float32), params)
        for _ in range(2)]
    for clip in (None, 0.5):
        kw = dict(lr=3e-2, weight_decay=0.2, clip_norm=clip)
        jopt, opt = jax_adamw(**kw), adamw(**kw)
        jp = jax.tree.map(jnp.asarray, params)
        tp = jax.tree.map(torch.from_numpy, params)
        js, ts = jopt.init(jp), opt.init(tp)
        for g in grads:
            jp, js, jm = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
            tp, ts, tm = opt.update(jax.tree.map(torch.from_numpy, g), ts,
                                    tp)
            np.testing.assert_allclose(tm["grad_norm"].item(),
                                       float(jm["grad_norm"]), rtol=1e-6)
        # the moments cancel where two gradients differ in sign: a few
        # ulps of the inputs become 1e-6 of the result
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, err_msg=k)
            for mom in ("m", "v"):
                np.testing.assert_allclose(ts[mom][k].numpy(),
                                           np.asarray(js[mom][k]), rtol=1e-5,
                                           atol=1e-8, err_msg=f"{mom} {k}")


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_three_adamw_steps_with_decay_match_jax(arch):
    """Three AdamW steps with the launchers' weight_decay=0.1 from one JAX
    ``TrainState``, per arch: the port decays the leaves whose JAX leaf
    (stacked over the layers) has rank >= 2, so the trajectories agree in
    every leaf, the blocks' norm scales included."""
    jcfg, cfg, params, _ = _setup(arch)
    pipe = make_pipeline(cfg, dict(seq_len=32, global_batch=2), seed=5)
    kw = dict(weight_decay=0.1, clip_norm=1.0)
    jopt = jax_adamw(lr=jax_cosine(1e-2, 1, 3), **kw)
    jstate = jax_init_train_state(jax.tree.map(jnp.asarray, params), jopt)
    state = train_state_from_jax(cfg, jax.tree.map(np.asarray, jstate))
    jstep = jax.jit(jax_make_train_step(jcfg, jopt))
    step = make_train_step(cfg, adamw(lr=cosine_schedule(1e-2, 1, 3), **kw))
    for i in range(3):
        batch = pipe.at(i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, batch)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=RTOL,
                                       err_msg=f"step {i} {k}")
    want = from_jax_params(cfg, jax.tree.map(np.asarray, jstate["params"]),
                           torch.float32)
    for name, w in want.items():
        assert_adam_close(state["params"][name], w, f"params {name}",
                          lr=1e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_decay_set_matches_jax(arch):
    """Leaf by leaf: the port's decay set is JAX's ``p.ndim >= 2`` on the
    JAX leaf. With zero gradients Adam's step is 0, so an update moves
    exactly the decayed leaves, each by lr·wd·p."""
    jcfg = jax_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    shapes = jax.eval_shape(lambda k: jax_init_model(jcfg, k),
                            jax.random.PRNGKey(0))
    params = dict(init_model(cfg, seed=0, device="cpu",
                             train=True).named_parameters())
    ranks = jax_ranks(cfg, params)
    for name, (path, _) in jax_leaf_paths(cfg).items():
        assert ranks[name] == _leaf(shapes, path).ndim, name
    opt = adamw(lr=0.5, weight_decay=0.1, clip_norm=None)
    gen = torch.Generator().manual_seed(0)
    params = {n: torch.randn(p.shape, generator=gen)
              for n, p in params.items()}
    new, _, _ = opt.update({n: torch.zeros_like(p) for n, p in
                            params.items()}, opt.init(params), params,
                           ranks=ranks)
    decayed = {n for n, p in params.items()
               if not torch.equal(new[n], p)}
    want = {n for n, (path, _) in jax_leaf_paths(cfg).items()
            if _leaf(shapes, path).ndim >= 2}
    assert decayed == want
    for n in want:
        torch.testing.assert_close(new[n], params[n] * (1 - 0.05),
                                   rtol=1e-6, atol=0)
    assert "final_norm" not in decayed
    # the blocks' (D,) norm scales, stacked to rank 2 in JAX
    assert any(params[n].dim() == 1 for n in decayed)


@pytest.mark.parametrize("arch", ("mixtral-8x22b", "deepseek-v2-236b"))
def test_training_leaf_dtypes_match_jax(arch):
    """A bf16 ``param_dtype`` trains every leaf in bf16, as JAX does,
    norm scales included."""
    jcfg = jax_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    assert cfg.param_dtype == "bfloat16"
    shapes = jax.eval_shape(lambda k: jax_init_model(jcfg, k),
                            jax.random.PRNGKey(0))
    params = dict(init_model(cfg, seed=0, device="cpu",
                             train=True).named_parameters())
    for name, (path, _) in jax_leaf_paths(cfg).items():
        want = str(_leaf(shapes, path).dtype)
        assert str(params[name].dtype) == f"torch.{want}", name
