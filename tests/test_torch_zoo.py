"""The model zoo in the port (gemma2-2b, internlm2-20b, minicpm3-4b with
MLA, mixtral-8x22b with MoE, deepseek-v2 with MLA, shared experts and a
leading dense layer, pixtral-12b with its patch frontend, hubert-xlarge's
audio encoder) against the JAX package's ``forward`` on the same
weights: JAX ``init_model`` → numpy → ``from_jax_params``, reduced
configs, prefill logits and three decode steps (pixtral's after a patch
prefill; hubert's encoder forward, with and without a frame mask).
Logits are compared, not tokens: a reduced random model repeats one
token. Beside them ``embed_inputs``, the caches' tree, ``runnable_cells``
and ``sub_quadratic`` against JAX's. The layers alone are in
test_torch_mla.py and test_torch_moe.py; the flash kernel itself runs on
the card only."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.configs import get_config as jax_get_config
from repro.models import forward as jax_forward
from repro.models import init_caches as jax_init_caches
from repro.models import init_model as jax_init_model
from repro.models.transformer import embed_inputs as jax_embed_inputs
from repro_torch import configs
from repro_torch.configs import get_config
from repro_torch.models import (ModelConfig, Transformer, forward,
                                init_caches, init_model)
from repro_torch.models.convert import from_jax_params
from repro_torch.models.transformer import embed_inputs

ARCHS = ("gemma2-2b", "internlm2-20b", "minicpm3-4b", "mixtral-8x22b",
         "deepseek-v2-236b", "pixtral-12b", "hubert-xlarge")
# The decoders fed tokens alone (pixtral's patch path and hubert's
# encoder have tests of their own).
TEXT = ARCHS[:5]
B = 2
# bf16 compute, bf16 cache: the frameworks round matmul outputs and
# residual sums to bf16 at different points, and the random models carry
# a one-step difference on through every layer (the readings here are
# 0.7-2% of the largest |logit|): held to 6e-2 of it, the JAX suite's
# bf16 limit. mixtral and deepseek-v2 are held in bf16 at the layer
# (test_torch_moe.py): a rounding can flip a near-tie of their routers.
BF16_REL = 6e-2


@pytest.fixture(scope="module")
def jax_params():
    """JAX init of each reduced arch, in its own param_dtype (mixtral's
    and deepseek-v2's bf16), once per module."""
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
                    steps=3, patches=None):
    """Logits (over the real vocabulary) of a prefill over toks[:, :n]
    (after ``patches``, when given) and ``steps`` decode steps, and the
    final caches, from both."""
    (jcfg, params), (cfg, model) = jax_side, port_side
    jc = jax_init_caches(jcfg, B, capacity, dtype=getattr(jnp, cache_dtype))
    tc = init_caches(cfg, B, capacity, dtype=getattr(torch, cache_dtype),
                     device="cpu")
    prefill = jax.jit(lambda p, b, c: jax_forward(
        p, jcfg, b, mode="prefill", caches=c))
    decode = jax.jit(lambda p, t, c, pos: jax_forward(
        p, jcfg, {"tokens": t}, mode="decode", caches=c, pos=pos))
    V = cfg.vocab_size
    batch = {"tokens": toks[:, :n]}
    if patches is not None:
        batch["patches"] = patches
    pos0 = n + (0 if patches is None else patches.shape[1])
    jl, jc, _ = prefill(params, {k: jnp.asarray(v) for k, v in batch.items()},
                        jc)
    with torch.no_grad():
        tl, tc = forward(model, {k: torch.from_numpy(v)
                                 for k, v in batch.items()},
                         mode="prefill", caches=tc)
    want, got = [_np(jl)[..., :V]], [_np(tl)[..., :V]]
    for i in range(steps):
        step = toks[:, n + i: n + i + 1]
        jl, jc, _ = decode(params, jnp.asarray(step), jc,
                           jnp.asarray(pos0 + i))
        with torch.no_grad():
            tl, tc = forward(model, {"tokens": torch.from_numpy(step)},
                             mode="decode", caches=tc, pos=pos0 + i)
        want.append(_np(jl)[..., :V])
        got.append(_np(tl)[..., :V])
    return want, got, jc, tc


def _encode(jax_side, port_side, batch):
    """An encoder's logits (over the real vocabulary) from both, mode
    "train", no cache."""
    (jcfg, params), (cfg, model) = jax_side, port_side
    jl, _, _ = jax.jit(lambda p, b: jax_forward(p, jcfg, b, mode="train"))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tl, caches = forward(model, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    assert caches is None
    V = cfg.vocab_size
    return _np(jl)[..., :V], _np(tl)[..., :V]


def _patches(cfg, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)


def _frames(cfg, S=40, seed=0):
    """Frame embeddings and HuBERT's span mask (spans of 10 frames from
    8% of the frames)."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, S), bool)
    for b in range(B):
        for s0 in rng.choice(S - 9, max(1, round(0.08 * S)), replace=False):
            mask[b, s0:s0 + 10] = True
    return (rng.standard_normal((B, S, cfg.frontend_dim)).astype(np.float32),
            mask)


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


def test_all_ten_archs_and_runnable_cells_match_jax():
    """Every architecture of the JAX package is ported: the registry,
    each full config's ``sub_quadratic``, and ``runnable_cells`` (no
    decode shapes for the encoder, long_500k only where sub-quadratic)
    equal JAX's."""
    assert configs.PORTED == configs.ARCHS == jax_configs.ARCHS
    assert configs.SHAPES == jax_configs.SHAPES
    assert configs.SHAPE_DEFS == jax_configs.SHAPE_DEFS
    assert configs.runnable_cells() == jax_configs.runnable_cells()
    for arch in configs.ARCHS:
        for reduced in (False, True):
            assert (get_config(arch, reduced).sub_quadratic
                    == jax_get_config(arch, reduced).sub_quadratic), arch


def test_qk_norm_still_raises():
    """No JAX config sets ``qk_norm``: the port refuses it until a
    caller needs it."""
    cfg = get_config("internlm2-20b", reduced=True).replace(qk_norm=True)
    with pytest.raises(NotImplementedError, match="qk_norm.*caller"):
        Transformer(cfg, "cpu")


@pytest.mark.parametrize("arch", TEXT)
def test_f32_prefill_and_decode_logits_match_jax(jax_params, arch):
    """f32 compute and cache: the same math, sums in another order →
    1e-4. A 40-token prefill is past gemma2's and mixtral's window of
    32 (their windowed caches wrap) and decodes on from there; deepseek's
    dense first layer and MoE layers take their own caches."""
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pixtral_patch_prefill_and_decode_match_jax(jax_params, dtype):
    """pixtral-smoke: 8 patches of width 32 before 20 text tokens, then
    three decode steps at positions past the patches; f32 at 1e-4, bf16
    at BF16_REL of the largest |logit|."""
    jax_side, port_side = _models("pixtral-12b", jax_params("pixtral-12b"),
                                  dtype)
    cfg = port_side[0]
    toks = _tokens(cfg, 23, seed=4)
    want, got, jc, tc = _prefill_decode(jax_side, port_side, toks, 20, 40,
                                        dtype, patches=_patches(cfg))
    assert got[0].shape == (B, cfg.frontend_tokens + 20, cfg.vocab_size)
    for w, g in zip(want, got):
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
        else:
            assert np.abs(g - w).max() <= BF16_REL * np.abs(w).max()


@pytest.mark.parametrize("masked", [False, True], ids=["frames", "masked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hubert_encoder_matches_jax(jax_params, dtype, masked):
    """hubert-smoke's encoder (not causal, gelu, the audio stub) over 40
    frames, with and without HuBERT's span mask; f32 at 1e-4, bf16 at
    BF16_REL of the largest |logit|."""
    jax_side, port_side = _models("hubert-xlarge",
                                  jax_params("hubert-xlarge"), dtype)
    frames, mask = _frames(port_side[0])
    batch = {"frames": frames, **({"mask": mask} if masked else {})}
    want, got = _encode(jax_side, port_side, batch)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


@pytest.mark.parametrize("case", ["tokens", "patches", "decode", "frames",
                                  "masked"])
def test_embed_inputs_matches_jax(jax_params, case):
    """``embed_inputs``' (x, positions, loss_mask) against JAX's: the
    vision stub with and without patches and at decode, the audio stub
    with and without a mask (f32)."""
    arch = "hubert-xlarge" if case in ("frames", "masked") else "pixtral-12b"
    (jcfg, params), (cfg, model) = _models(arch, jax_params(arch), "float32")
    mode, pos = ("decode", 7) if case == "decode" else ("prefill", None)
    if arch == "hubert-xlarge":
        frames, mask = _frames(cfg, seed=1)
        batch = {"frames": frames, **({"mask": mask} if case == "masked"
                                      else {})}
    else:
        batch = {"tokens": _tokens(cfg, 1 if case == "decode" else 12)}
        if case == "patches":
            batch["patches"] = _patches(cfg, seed=2)
    jx, jpos, jmask = jax_embed_inputs(
        params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}, mode,
        None if pos is None else jnp.asarray(pos), jnp.float32)
    with torch.no_grad():
        tx, tpos, tmask = embed_inputs(
            model, {k: torch.from_numpy(v) for k, v in batch.items()}, mode,
            pos)
    np.testing.assert_allclose(_np(tx), _np(jx), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        np.broadcast_to(tpos.numpy(), np.shape(jpos)), np.asarray(jpos))
    if jmask is None:
        assert tmask is None
    else:
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
        assert not tmask[:, :cfg.frontend_tokens].any()
        assert tmask[:, cfg.frontend_tokens:].all()
    if case == "masked":
        m = torch.from_numpy(batch["mask"])
        assert torch.equal(tx[m], model.mask_emb.float().expand(
            int(m.sum()), -1))


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "pixtral-12b",
                                  "hubert-xlarge", "minicpm3-4b"])
def test_init_caches_tree_matches_jax(arch):
    """The caches' tree and shapes equal JAX's: deepseek's leading dense
    layer in ``dense_layers`` beside the MoE layers' ``layers`` (both
    MLA latents), pixtral's GQA stack, hubert's {} (an encoder keeps no
    cache)."""
    jc = jax_init_caches(jax_get_config(arch, reduced=True), B, 24)
    tc = init_caches(get_config(arch, reduced=True), B, 24, device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), jc) == jax.tree.map(
        lambda t: tuple(t.shape), tc)


def test_encoder_refuses_prefill_and_decode(jax_params):
    """JAX's encoder runs through mode "train" only (its prefill, with
    no cache, fails in ``attn_apply``): the port refuses prefill and
    decode with a ValueError that says so."""
    (_, _), (cfg, model) = _models("hubert-xlarge",
                                   jax_params("hubert-xlarge"), "float32")
    frames, _ = _frames(cfg)
    for mode, pos in (("prefill", None), ("decode", 3)):
        with pytest.raises(ValueError, match="encoder.*train"):
            forward(model, {"frames": torch.from_numpy(frames)}, mode=mode,
                    caches={}, pos=pos)


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


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "pixtral-12b",
                                  "hubert-xlarge"])
def test_convert_uses_every_leaf(jax_params, arch):
    """Every JAX leaf lands in exactly one port parameter: the state's
    names are the model's, and its element count is the tree's.
    deepseek's ``dense_blocks`` become layer 0 (an MLP of width d_ff),
    ``blocks`` layers 1.. with the shared experts; the frontends'
    projections and ``mask_emb`` are read, cast to the compute dtype."""
    params = jax.tree.map(np.asarray, jax_params(arch))
    cfg = get_config(arch, reduced=True)
    state = from_jax_params(cfg, params)
    model = Transformer(cfg, "cpu")
    assert set(state) == set(model.state_dict())
    assert sum(t.numel() for t in state.values()) == sum(
        a.size for a in jax.tree.leaves(params))
    if arch == "deepseek-v2-236b":
        np.testing.assert_array_equal(
            state["blocks.0.mlp.w_up"].float().numpy(),
            params["dense_blocks"]["mlp"]["w_up"][0].astype(np.float32))
        np.testing.assert_array_equal(
            state["blocks.2.moe.shared.w_down"].float().numpy(),
            params["blocks"]["moe"]["shared"]["w_down"][1].astype(
                np.float32))
        assert not hasattr(model.blocks[0], "moe")
    for name in ("patch_proj", "frame_proj", "mask_emb"):
        if name in params:     # cast once to the compute dtype
            want = torch.from_numpy(params[name].astype(np.float32)).to(
                getattr(torch, cfg.dtype))
            assert torch.equal(state[name], want), name


@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_draws_every_weight(arch):
    """The port's own seeded draws (what the card serves): every
    parameter finite, every matrix drawn (not zero), norms at 0 (scale
    1), hubert's ``mask_emb`` drawn, and a prefill and decode step run
    (hubert: its encoder forward; pixtral: after patches)."""
    cfg = get_config(arch, reduced=True)
    model = init_model(cfg, seed=0, device="cpu")
    for name, p in model.named_parameters():
        assert torch.isfinite(p).all(), name
        if p.dim() >= 2 or name == "mask_emb":
            assert p.float().std() > 0, name
        elif "norm" in name or name.split(".")[-1].startswith("ln"):
            assert torch.all(p == 0), name
    if cfg.is_encoder:
        frames, mask = _frames(cfg)
        with torch.no_grad():
            logits, _ = forward(model, {"frames": torch.from_numpy(frames),
                                        "mask": torch.from_numpy(mask)})
        assert logits.shape == (B, 40, cfg.padded_vocab)
        assert torch.isfinite(logits).all()
        return
    caches = init_caches(cfg, B, 32, device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens(cfg, 12))}
    if cfg.frontend == "vision_stub":
        batch["patches"] = torch.from_numpy(_patches(cfg))
    n = 12 + (cfg.frontend_tokens if "patches" in batch else 0)
    with torch.no_grad():
        logits, caches = forward(model, batch, mode="prefill",
                                 caches=caches)
        step, _ = forward(model, {"tokens": batch["tokens"][:, :1]},
                          mode="decode", caches=caches, pos=n)
    assert logits.shape == (B, n, cfg.padded_vocab)
    assert torch.isfinite(step).all()
