"""The port's MoE layer (``models/layers/mlp.py`` ``MoE``) against the JAX
package's ``moe_apply`` on the same numpy inputs and weights (mixtral-8x22b's
reduced config: D 64, 4 experts, top 2, expert width 128): the dropless
single group of decode and short prompts, the capacity path with padded
groups that drops routes, the router's aux loss, and bf16 at the layer;
and deepseek-v2's (8 experts, top 2, expert width 32, one shared expert
run densely beside the routed ones) through the same paths."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.layers.mlp import init_moe, moe_apply
from repro_torch.configs import get_config
from repro_torch.models.layers.mlp import MoE


def _layers(dtype, arch="mixtral-8x22b"):
    """JAX's params (mixtral's and deepseek-v2's bf16 param_dtype) and
    the port's MoE holding the same values (the shared experts' MLP
    under ``shared.``)."""
    jcfg = jax_get_config(arch, reduced=True).replace(dtype=dtype)
    cfg = get_config(arch, reduced=True).replace(dtype=dtype)
    params = init_moe(jax.random.PRNGKey(1), jcfg,
                      jnp.dtype(jcfg.param_dtype))
    td = getattr(torch, dtype)
    moe = MoE(cfg, td, "cpu")
    flat = {}
    for k, v in params.items():
        for name, leaf in (v.items() if isinstance(v, dict) else [(None, v)]):
            flat[k if name is None else f"{k}.{name}"] = leaf
    moe.load_state_dict({k: torch.from_numpy(np.array(v, np.float32)).to(
        td) for k, v in flat.items()})
    return (jcfg, params), (cfg, moe)


def _x(B, S, D, offset, seed=0):
    """Hidden states with a shared component of size ``offset``, which
    skews the router towards some experts (as real hidden states do)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, D))
            + offset * rng.standard_normal(D)).astype(np.float32)


def _run(dtype, x, arch="mixtral-8x22b"):
    """(JAX out, JAX aux, port out, port aux, the port's routing)."""
    (jcfg, params), (cfg, moe) = _layers(dtype, arch)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jo, ja = jax.jit(lambda p, x: moe_apply(p, x, jcfg, dtype=jd))(
        params, jnp.asarray(x).astype(jd))
    routes = []
    route = moe.route

    def capture(*args):
        routes.append(route(*args))
        return routes[-1]
    moe.route = capture
    with torch.no_grad():
        to, ta = moe(torch.from_numpy(x).to(td), td)
    assert to.dtype == td and to.shape == x.shape
    return (np.asarray(jo.astype(jnp.float32)), float(ja),
            to.float().numpy(), float(ta), routes[0])


@pytest.mark.parametrize("B,S", [(2, 16), (4, 1)], ids=["prefill", "decode"])
def test_dropless_group_matches_jax(B, S):
    """T ≤ 256: one group, capacity gs·K, no route dropped."""
    x = _x(B, S, 64, 1.0)
    jo, ja, to, ta, (_, _, _, ranks, C) = _run("float32", x)
    assert C == B * S * 2 and bool((ranks < C).all())
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ta, ja, rtol=1e-6)


def test_capacity_groups_with_padding_drop_as_jax():
    """T = 600 > 256: three groups of 256 (the last padded by 168 tokens
    of zero probability), C = int(1.25·256·2/4) = 160 a group and expert;
    the skewed router sends more than C routes to some expert, and the
    port drops exactly JAX's (the flattened (token, k) order decides)."""
    x = _x(2, 300, 64, 1.0)
    jo, ja, to, ta, (probs, gate, sel, ranks, C) = _run("float32", x)
    T = 600
    assert probs.shape == (768, 4) and C == 160
    assert bool((probs[T:] == 0).all())
    dropped = int((ranks[:T] >= C).sum())
    assert dropped > 0, "the capacity path dropped no route"
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ta, ja, rtol=1e-6)


def test_pad_tokens_take_the_first_experts():
    """A pad token's probabilities are all 0: top_k's order (the lower
    index first among ties) sends it to experts 0 and 1 with gate 0."""
    x = _x(2, 300, 64, 0.0)
    *_, (probs, gate, sel, ranks, C) = _run("float32", x)
    assert sel[600:].tolist() == [[0, 1]] * 168
    assert bool((gate[600:] == 0).all())


@pytest.mark.parametrize("B,S,offset", [(2, 16, 0.0), (2, 300, 0.0),
                                        (2, 300, 1.0)])
def test_aux_loss_matches_jax(B, S, offset):
    """The router's load-balancing loss E·Σ mean(probs)·share(routes),
    pad rows included as in JAX."""
    _, ja, _, ta, _ = _run("float32", _x(B, S, 64, offset, seed=4))
    np.testing.assert_allclose(ta, ja, rtol=1e-6)


@pytest.mark.parametrize("B,S", [(2, 16), (2, 300)])
def test_bf16_layer_matches_jax(B, S):
    """bf16 weights (mixtral's param_dtype) and bf16 inputs: both sum the
    same bf16 products in f32 and round the output once, so an output may
    differ by a bf16 step; held to two steps of the largest |out|
    (2^-6 of it). The routes, and so the drops, are the same."""
    jo, ja, to, ta, (_, _, _, ranks, C) = _run("bfloat16",
                                              _x(B, S, 64, 1.0, seed=5))
    assert np.abs(to - jo).max() <= 2.0 ** -6 * np.abs(jo).max()
    np.testing.assert_allclose(ta, ja, rtol=1e-5)
    if B * S > 256:
        assert int((ranks[:B * S] >= C).sum()) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S", [(2, 16), (4, 1), (2, 300)],
                         ids=["prefill", "decode", "capacity"])
def test_shared_experts_match_jax(B, S, dtype):
    """deepseek-v2's MoE: the shared expert (an MLP of width moe_d_ff ·
    n_shared_experts on every token) added after the routed combine, as
    JAX's ``moe_apply`` adds it; dropless and capacity paths (C =
    int(1.25·256·2/8) = 80 a group of 256). f32 at 1e-5 as the routed
    layer; bf16 at two bf16 steps of the largest |out|."""
    x = _x(B, S, 64, 1.0, seed=6)
    jo, ja, to, ta, (_, _, _, ranks, C) = _run(dtype, x, "deepseek-v2-236b")
    if B * S > 256:
        assert C == 80 and int((ranks[:B * S] >= C).sum()) > 0
    if dtype == "float32":
        np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ta, ja, rtol=1e-6)
    else:
        assert np.abs(to - jo).max() <= 2.0 ** -6 * np.abs(jo).max()
    (_, params), (cfg, moe) = _layers("float32", "deepseek-v2-236b")
    assert cfg.n_shared_experts == 1
    assert tuple(moe.shared.w_up.shape) == (64, cfg.moe_d_ff)
