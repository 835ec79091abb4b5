"""The model zoo's text decoders in the port (gemma2-2b, internlm2-20b,
minicpm3-4b with MLA, mixtral-8x22b with MoE) against the JAX package's
``forward`` on the same weights: JAX ``init_model`` → numpy →
``from_jax_params``, reduced configs, prefill logits and three decode
steps. Logits are compared, not tokens: a reduced random model repeats
one token. The layers alone are in test_torch_mla.py and
test_torch_moe.py; the flash kernel itself runs on the card only."""
import dataclasses

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
from repro_torch.models import (ModelConfig, Transformer, forward,
                                init_caches, init_model)
from repro_torch.models.convert import from_jax_params

ARCHS = ("gemma2-2b", "internlm2-20b", "minicpm3-4b", "mixtral-8x22b")
LATER = ("deepseek-v2-236b", "pixtral-12b", "hubert-xlarge")
B = 2
# bf16 compute, bf16 cache: the frameworks round matmul outputs and
# residual sums to bf16 at different points, and the random models carry
# a one-step difference on through every layer (the readings here are
# 0.7-2% of the largest |logit|): held to 6e-2 of it, the JAX suite's
# bf16 limit. mixtral is held in bf16 at the layer (test_torch_moe.py):
# a rounding can flip a near-tie of its router.
BF16_REL = 6e-2


@pytest.fixture(scope="module")
def jax_params():
    """JAX init of each reduced arch, in its own param_dtype (mixtral's
    bf16), once per module."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = jax_get_config(arch, reduced=True)
            cache[arch] = jax.jit(jax_init_model, static_argnums=0)(
                jcfg, jax.random.PRNGKey(0))
        return cache[arch]
    return get


def _models(arch, params, dtype):
    jcfg = jax_get_config(arch, reduced=True).replace(dtype=dtype)
    cfg = get_config(arch, reduced=True).replace(dtype=dtype)
    model = Transformer(cfg, "cpu")
    model.load_state_dict(from_jax_params(
        cfg, jax.tree.map(np.asarray, params)))
    return (jcfg, params), (cfg, model)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _prefill_decode(jax_side, port_side, toks, n, capacity, cache_dtype,
                    steps=3):
    """Logits (over the real vocabulary) of a prefill over toks[:, :n]
    and ``steps`` decode steps, and the final caches, from both."""
    (jcfg, params), (cfg, model) = jax_side, port_side
    jc = jax_init_caches(jcfg, B, capacity, dtype=getattr(jnp, cache_dtype))
    tc = init_caches(cfg, B, capacity, dtype=getattr(torch, cache_dtype),
                     device="cpu")
    prefill = jax.jit(lambda p, t, c: jax_forward(
        p, jcfg, {"tokens": t}, mode="prefill", caches=c))
    decode = jax.jit(lambda p, t, c, pos: jax_forward(
        p, jcfg, {"tokens": t}, mode="decode", caches=c, pos=pos))
    V = cfg.vocab_size
    jl, jc, _ = prefill(params, jnp.asarray(toks[:, :n]), jc)
    with torch.no_grad():
        tl, tc = forward(model, {"tokens": torch.from_numpy(toks[:, :n])},
                         mode="prefill", caches=tc)
    want, got = [_np(jl)[..., :V]], [_np(tl)[..., :V]]
    for i in range(steps):
        step = toks[:, n + i: n + i + 1]
        jl, jc, _ = decode(params, jnp.asarray(step), jc, jnp.asarray(n + i))
        with torch.no_grad():
            tl, tc = forward(model, {"tokens": torch.from_numpy(step)},
                             mode="decode", caches=tc, pos=n + i)
        want.append(_np(jl)[..., :V])
        got.append(_np(tl)[..., :V])
    return want, got, jc, tc


def _tokens(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n))


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax_field_for_field(arch, reduced):
    want = jax_get_config(arch, reduced=reduced)
    got = get_config(arch, reduced=reduced)
    names = [f.name for f in dataclasses.fields(want)]
    assert names == [f.name for f in dataclasses.fields(ModelConfig)]
    assert {n: getattr(got, n) for n in names} == {
        n: getattr(want, n) for n in names}


@pytest.mark.parametrize("arch", LATER)
def test_remaining_archs_name_slice_13(arch):
    with pytest.raises(NotImplementedError, match="slice 13"):
        get_config(arch)


def test_model_options_of_slice_13_raise():
    """deepseek-v2's shared experts and leading dense layer are refused
    by name (its config built from the JAX fields)."""
    jc = jax_get_config("deepseek-v2-236b", reduced=True)
    cfg = ModelConfig(**{f.name: getattr(jc, f.name)
                         for f in dataclasses.fields(ModelConfig)})
    with pytest.raises(NotImplementedError,
                       match="n_shared_experts, first_dense_layers.*slice "
                             "13"):
        Transformer(cfg, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_prefill_and_decode_logits_match_jax(jax_params, arch):
    """f32 compute and cache: the same math, sums in another order →
    1e-4. A 40-token prefill is past gemma2's and mixtral's window of
    32 (their windowed caches wrap) and decodes on from there."""
    jax_side, port_side = _models(arch, jax_params(arch), "float32")
    toks = _tokens(port_side[0], 43)
    want, got, _, _ = _prefill_decode(jax_side, port_side, toks, 40, 64,
                                      "float32")
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS[:3])
def test_bf16_logits_match_jax(jax_params, arch):
    jax_side, port_side = _models(arch, jax_params(arch), "bfloat16")
    toks = _tokens(port_side[0], 43, seed=2)
    want, got, _, _ = _prefill_decode(jax_side, port_side, toks, 40, 64,
                                      "bfloat16")
    for w, g in zip(want, got):
        assert np.abs(g - w).max() <= BF16_REL * np.abs(w).max()


def test_gemma2_local_global_ring_wraps(jax_params):
    """gemma2-smoke: a 70-token prefill into capacity 80, past the local
    layers' window of 32, then three decode steps. The local layers'
    ring buffers (32 slots) wrap at prefill and again at decode, the
    global layers' (80) do not; the caches equal JAX's, pair for pair."""
    jax_side, port_side = _models("gemma2-2b", jax_params("gemma2-2b"),
                                  "float32")
    cfg = port_side[0]
    toks = _tokens(cfg, 73, seed=3)
    want, got, jc, tc = _prefill_decode(jax_side, port_side, toks, 70, 80,
                                        "float32")
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    half, KV, Dh = cfg.n_layers // 2, cfg.n_kv_heads, cfg.d_head
    for kind, cap in (("local", cfg.window), ("global", 80)):
        for n in ("k", "v"):
            t = tc["layers"][kind][n]
            assert t.shape == (half, B, cap, KV, Dh)
            np.testing.assert_allclose(_np(t), _np(jc["layers"][kind][n]),
                                       rtol=1e-4, atol=1e-4)


def test_gemma2_scales_the_embedding_in_the_compute_dtype():
    """√D rounded to bf16 (64 → 8.0 exactly; 2304 → 48.0; 60 → 7.75 in
    bf16, 7.7459... in f32), as JAX's ``jnp.asarray(√D, dtype)``."""
    cfg = get_config("gemma2-2b", reduced=True).replace(
        d_model=60, n_layers=2, dtype="bfloat16")
    model = init_model(cfg, seed=0, device="cpu")
    with torch.no_grad():
        model.embed.fill_(1.0)
        captured = {}

        def grab(module, args, kwargs):
            captured["x"] = args[0]
        hook = model.blocks[0].register_forward_pre_hook(grab,
                                                         with_kwargs=True)
        forward(model, {"tokens": torch.zeros(1, 2, dtype=torch.long)})
        hook.remove()
    assert torch.all(captured["x"] == 7.75)


def test_convert_interleaves_pairs_and_keeps_norms_f32(jax_params):
    """Layer 2i is the local tree's i, layer 2i + 1 the global tree's;
    the post-norms and MLA's norms stay f32; mixtral's bf16 leaves are
    read exactly."""
    params = jax.tree.map(np.asarray, jax_params("gemma2-2b"))
    cfg = get_config("gemma2-2b", reduced=True)
    state = from_jax_params(cfg, params)
    for i in range(cfg.n_layers):
        kind = "global" if i % 2 else "local"
        want = params["blocks"][kind]["attn"]["wq"][i // 2]
        np.testing.assert_array_equal(
            state[f"blocks.{i}.attn.wq"].float().numpy(),
            want.astype(np.float32).astype(jnp.bfloat16).astype(np.float32))
        assert state[f"blocks.{i}.ln1b"].dtype == torch.float32
        assert state[f"blocks.{i}.ln2b"].dtype == torch.float32
    mcfg = get_config("minicpm3-4b", reduced=True)
    mstate = from_jax_params(mcfg, jax.tree.map(
        np.asarray, jax_params("minicpm3-4b")))
    assert mstate["blocks.0.attn.q_a_norm"].dtype == torch.float32
    assert mstate["blocks.0.attn.kv_a_norm"].dtype == torch.float32
    assert mstate["blocks.0.attn.wq_b"].dtype == torch.bfloat16
    xparams = jax.tree.map(np.asarray, jax_params("mixtral-8x22b"))
    xcfg = get_config("mixtral-8x22b", reduced=True)
    xstate = from_jax_params(xcfg, xparams)
    want = xparams["blocks"]["moe"]["w_down"][2].astype(np.float32)
    assert xstate["blocks.2.moe.w_down"].shape == want.shape
    np.testing.assert_array_equal(xstate["blocks.2.moe.w_down"].float(),
                                  want)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_draws_every_weight(arch):
    """The port's own seeded draws (what the card serves): every
    parameter finite, every matrix drawn (not zero), norms at 0 (scale
    1), and a prefill and decode step run."""
    cfg = get_config(arch, reduced=True)
    model = init_model(cfg, seed=0, device="cpu")
    for name, p in model.named_parameters():
        assert torch.isfinite(p).all(), name
        if p.dim() >= 2:
            assert p.float().std() > 0, name
        elif "norm" in name or name.split(".")[-1].startswith("ln"):
            assert torch.all(p == 0), name
    caches = init_caches(cfg, B, 32, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 12))
    with torch.no_grad():
        logits, caches = forward(model, {"tokens": toks}, mode="prefill",
                                 caches=caches)
        step, _ = forward(model, {"tokens": toks[:, :1]}, mode="decode",
                          caches=caches, pos=12)
    assert logits.shape == (B, 12, cfg.padded_vocab)
    assert torch.isfinite(step).all()
