"""The port's MLA layer (``models/layers/mla.py``) against the JAX
package's ``mla_apply`` on the same numpy inputs and weights
(minicpm3-4b's reduced config: D 64, 4 heads, q_lora 32, kv_lora 16,
nope/rope 8/4, v 8; deepseek-v2's: kv_lora 16, nope/rope 8/4, v 8):
train, prefill, and decode past the latent cache's capacity; and the
flash wrapper's head-dim pairs (the kernel, at minicpm3-4b's Dk 288 / Dv
256 and deepseek-v2's Dk 576 / Dv 512, runs on the card only:
tests/test_torch_kernels_cuda.py, chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.layers.mla import init_mla, init_mla_cache, mla_apply
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention.kernel import (flash_attention,
                                                        supported_dims)
from repro_torch.models.layers.mla import MLA

B = 2


def _layers(dtype, q_lora=None, seed=1, arch="minicpm3-4b"):
    """JAX's MLA params, with random (nonzero) norm scales, and the
    port's MLA holding the same values (norms in f32)."""
    jcfg = jax_get_config(arch, reduced=True).replace(dtype=dtype)
    cfg = get_config(arch, reduced=True).replace(dtype=dtype)
    if q_lora is not None:
        jcfg, cfg = jcfg.replace(q_lora_rank=q_lora), cfg.replace(
            q_lora_rank=q_lora)
    params = init_mla(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    for n in ("q_a_norm", "kv_a_norm"):
        if n in params:
            params[n] = jnp.asarray(
                0.3 * rng.standard_normal(params[n].shape), jnp.float32)
    td = getattr(torch, dtype)
    layer = MLA(cfg, td, "cpu")
    layer.load_state_dict({
        k: torch.from_numpy(np.array(v, np.float32)).to(
            torch.float32 if k.endswith("norm") else td)
        for k, v in params.items()})
    return (jcfg, params), (cfg, layer)


def _x(S, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, S, 64)).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _run(dtype, S, capacity, steps, q_lora=None, arch="minicpm3-4b"):
    """Outputs of a prefill over S tokens and ``steps`` decode steps,
    and the final latent caches, from both frameworks."""
    (jcfg, params), (cfg, layer) = _layers(dtype, q_lora, arch=arch)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    x = _x(S + steps)
    jc = init_mla_cache(jcfg, B, capacity, jd)
    tc = {n: torch.from_numpy(_np(t)).to(td) for n, t in jc.items()}
    prefill = jax.jit(lambda p, x, c: mla_apply(
        p, x, jcfg, positions=jnp.arange(S)[None], cache=c, mode="prefill",
        dtype=jd))
    decode = jax.jit(lambda p, x, c, pos: mla_apply(
        p, x, jcfg, positions=jnp.full((B, 1), pos), cache=c, pos=pos,
        mode="decode", dtype=jd))
    jo, jc = prefill(params, jnp.asarray(x[:, :S]).astype(jd), jc)
    with torch.no_grad():
        to, tc = layer(torch.from_numpy(x[:, :S]).to(td),
                       positions=torch.arange(S)[None], cache=tc,
                       mode="prefill", dtype=td)
    want, got = [_np(jo)], [_np(to)]
    for i in range(steps):
        pos = S + i
        xi = x[:, pos:pos + 1]
        jo, jc = decode(params, jnp.asarray(xi).astype(jd), jc,
                        jnp.asarray(pos))
        with torch.no_grad():
            to, tc = layer(torch.from_numpy(xi).to(td),
                           positions=torch.full((B, 1), pos), cache=tc,
                           pos=pos, mode="decode", dtype=td)
        want.append(_np(jo))
        got.append(_np(to))
    return want, got, jc, tc


@pytest.mark.parametrize("q_lora,arch", [
    (None, "minicpm3-4b"), (0, "minicpm3-4b"), (None, "deepseek-v2-236b")],
    ids=["q_lora32", "full_q", "deepseek_v2"])
def test_f32_prefill_and_decode_past_capacity_match_jax(q_lora, arch):
    """A 12-token prefill into 16 latent slots, then 8 decode steps: the
    ring wraps at position 16 and decode keeps attending over the last
    16. f32: the same math, sums in another order → 1e-4 (JAX's own
    limit for the port's f32 logits); the caches too."""
    want, got, jc, tc = _run("float32", 12, 16, 8, q_lora, arch)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    for n in ("ckv", "krope"):
        np.testing.assert_allclose(_np(tc[n]), _np(jc[n]), rtol=1e-4,
                                   atol=1e-4)


def test_f32_train_matches_jax():
    (jcfg, params), (cfg, layer) = _layers("float32")
    x = _x(40, seed=3)
    want, _ = mla_apply(params, jnp.asarray(x), jcfg,
                        positions=jnp.arange(40)[None], mode="train",
                        dtype=jnp.float32)
    with torch.no_grad():
        got, _ = layer(torch.from_numpy(x), positions=torch.arange(40)[None],
                       mode="train", dtype=torch.float32)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_bf16_matches_jax():
    """bf16 weights and caches: the frameworks round the projections'
    outputs to bf16 at the same points but sum in another order, so an
    element may land a bf16 step or two away; held to 2e-2 of the largest
    |out| (the port's bf16 logit limit)."""
    want, got, _, _ = _run("bfloat16", 12, 16, 6)
    for w, g in zip(want, got):
        assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max()


def test_prefill_longer_than_the_cache_raises():
    (_, _), (cfg, layer) = _layers("float32")
    cache = {"ckv": torch.zeros(B, 8, cfg.kv_lora_rank),
             "krope": torch.zeros(B, 8, cfg.qk_rope_dim)}
    with pytest.raises(ValueError, match="cache of 8"):
        layer(torch.zeros(B, 9, 64), positions=torch.arange(9)[None],
              cache=cache, mode="prefill", dtype=torch.float32)


@pytest.mark.parametrize("dk,dv,ok", [
    (64, 64, True), (80, 64, True), (256, 256, True), (288, 256, True),
    (273, 241, True), (300, 256, False), (288, 240, False),
    (288, 288, False), (256, 288, False), (304, 256, False),
    (0, 64, False), (576, 512, True), (570, 500, True), (576, 480, False),
    (592, 512, False), (512, 576, False), (576, 256, False)])
def test_flash_wrapper_head_dim_pairs(dk, dv, ok):
    """The wrapper's head-dim check, read from the CUDA source's one list
    of its instances, takes Dk, Dv ≤ 256 and the pairs that round up to
    (288, 256) and (576, 512). On CPU tensors the wrapper raises before any of it and
    falls back to nothing (the card refuses the other pairs:
    tests/test_torch_kernels_cuda.py)."""
    assert supported_dims(dk, dv) is ok
    q = torch.zeros(1, 4, 2, dk)
    k = torch.zeros(1, 4, 1, dk)
    v = torch.zeros(1, 4, 1, dv)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v)
