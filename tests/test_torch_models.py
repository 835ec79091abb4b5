"""Port model (reduced smollm) against the JAX package's forward on the
same weights: JAX ``init_model`` → numpy → ``from_jax_params``. Logits
are compared, not only tokens: the random-init reduced model repeats
one token, so tokens alone would hide most differences."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import forward as jax_forward
from repro.models import init_caches as jax_init_caches
from repro.models import init_model as jax_init_model
from repro_torch.configs import get_config
from repro_torch.models import Transformer, forward, init_caches
from repro_torch.models.convert import from_jax_params

B = 2


@pytest.fixture(scope="module")
def params():
    """JAX init (param_dtype f32, whatever the compute dtype)."""
    jcfg = jax_get_config("smollm-360m", reduced=True)
    return jax.jit(jax_init_model, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))


def _models(params, dtype):
    jcfg = jax_get_config("smollm-360m", reduced=True).replace(dtype=dtype)
    cfg = get_config("smollm-360m", reduced=True).replace(dtype=dtype)
    model = Transformer(cfg, "cpu")
    model.load_state_dict(from_jax_params(
        cfg, jax.tree.map(np.asarray, params)))
    return (jcfg, params), (cfg, model)


@pytest.fixture(scope="module")
def f32(params):
    return _models(params, "float32")


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(
        x, jax.Array) else x.float().numpy()


def _prefill_decode(jax_side, port_side, toks, n, capacity, cache_dtype):
    """Logits of a prefill over toks[:, :n] and three decode steps, from
    both frameworks."""
    (jcfg, params), (cfg, model) = jax_side, port_side
    jc = jax_init_caches(jcfg, B, capacity, dtype=getattr(jnp, cache_dtype))
    tc = init_caches(cfg, B, capacity, dtype=getattr(torch, cache_dtype),
                     device="cpu")
    prefill = jax.jit(lambda p, t, c: jax_forward(
        p, jcfg, {"tokens": t}, mode="prefill", caches=c))
    decode = jax.jit(lambda p, t, c, pos: jax_forward(
        p, jcfg, {"tokens": t}, mode="decode", caches=c, pos=pos))
    want, got = [], []
    jl, jc, _ = prefill(params, jnp.asarray(toks[:, :n]), jc)
    with torch.no_grad():
        tl, tc = forward(model, {"tokens": torch.from_numpy(toks[:, :n])},
                         mode="prefill", caches=tc)
    want.append(_np(jl))
    got.append(_np(tl))
    for i in range(3):
        step = toks[:, n + i: n + i + 1]
        jl, jc, _ = decode(params, jnp.asarray(step), jc, jnp.asarray(n + i))
        with torch.no_grad():
            tl, tc = forward(model, {"tokens": torch.from_numpy(step)},
                             mode="decode", caches=tc, pos=n + i)
        want.append(_np(jl))
        got.append(_np(tl))
    return want, got


def _tokens(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n))


@pytest.mark.parametrize("n,capacity", [(20, 64), (40, 32)],
                         ids=["fits", "capacity-wrap"])
def test_f32_prefill_and_decode_logits_match_jax(f32, n, capacity):
    """f32, f32 cache: same math, sums in another order → 1e-4. The
    capacity-wrap case prefills S > capacity (the ring keeps the last C
    entries rotated) and decodes on past it."""
    toks = _tokens(f32[1][0], n + 3)
    want, got = _prefill_decode(*f32, toks, n, capacity, "float32")
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_f32_train_forward_matches_jax(f32):
    (jcfg, params), (cfg, model) = f32
    toks = _tokens(cfg, 33, seed=1)
    want, _, _ = jax_forward(params, jcfg, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, _ = forward(model, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_bf16_logits_match_jax(params):
    """bf16 compute, default bf16 cache. The two frameworks round matmul
    outputs and residual sums to bf16 (8 significant bits) at different
    points, so a logit may move by a few bf16 steps of the logit scale
    (one step is 2^-7 of it at the top of a binade): held to 2e-2 of the
    largest |logit|, i.e. within the 1e-1 bound for bf16 comparisons."""
    jax_side, port_side = _models(params, "bfloat16")
    toks = _tokens(port_side[0], 23)
    want, got = _prefill_decode(jax_side, port_side, toks, 20, 64,
                                "bfloat16")
    for w, g in zip(want, got):
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= 2e-2 * scale


def test_convert_rejects_wrong_depth(f32):
    (_, params), (cfg, _) = f32
    with pytest.raises(ValueError, match="layers"):
        from_jax_params(cfg.replace(n_layers=cfg.n_layers + 1),
                        jax.tree.map(np.asarray, params))


def test_unported_arch_names_its_slice():
    """Every arch of the JAX package is ported; a name outside them
    raises, listing the known ones."""
    assert get_config("deepseek-v2-236b").name == "deepseek-v2-236b"
    with pytest.raises(KeyError, match="hubert-xlarge"):
        get_config("llama-70b")
