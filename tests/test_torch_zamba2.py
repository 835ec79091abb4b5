"""Port zamba2 (plain SSD scan, causal conv, Mamba-2 layer, reduced
zamba2-2.7b model with its shared attention block, serving) against the
JAX package on the same numpy inputs and converted weights. The CUDA
kernel itself runs only on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.ssm_scan.chunked import \
    ssm_decode_step as jax_decode_step
from repro.kernels.ssm_scan.chunked import \
    ssm_scan_chunked as jax_chunked
from repro.kernels.ssm_scan.kernel import ssm_scan as jax_pallas
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_ref
from repro.models import forward as jax_forward
from repro.models import init_caches as jax_init_caches
from repro.models import init_model as jax_init_model
from repro.models.layers import mamba2 as jax_mamba2
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.kernels.ssm_scan import ops
from repro_torch.kernels.ssm_scan.chunked import (ssm_decode_step,
                                                  ssm_scan_chunked)
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.models import Transformer, forward, init_caches
from repro_torch.models.convert import from_jax_params
from repro_torch.models.layers.mamba2 import Mamba2, causal_conv
from repro_torch.serve import ServeEngine

# The JAX suite's own SSD limits (tests/test_kernels.py): f32 sums in
# another order and through exp of cumulative decays; bf16 one output
# rounding apart.
TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
       "bfloat16": dict(rtol=6e-2, atol=6e-2)}
SHAPES = [(64, 32), (100, 32), (256, 64)]   # (S, chunk); B=2 H=4 P=16 G=2 N=8
B = 2

_jax_chunked = jax.jit(jax_chunked, static_argnames="chunk")
_jax_ref = jax.jit(jax_ref)


def _ssd_inputs(S, seed, B=2, H=4, P=16, G=2, N=8, dt_scale=1.0):
    """x, dt (post-softplus, f32), a (< 0), Bm, Cm, D and a nonzero h0,
    drawn as the JAX suite draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P), np.float32)
    dt = dt_scale * np.log1p(np.exp(rng.standard_normal((B, S, H))))
    a = -np.exp(0.5 * rng.standard_normal(H))
    Bm, Cm = (rng.standard_normal((B, S, G, N), np.float32)
              for _ in range(2))
    D = 0.1 * rng.standard_normal(H)
    h0 = 0.3 * rng.standard_normal((B, H, P, N))
    f32 = np.float32
    return (x, dt.astype(f32), a.astype(f32), Bm, Cm, D.astype(f32),
            h0.astype(f32))


def _split(inputs, dtype):
    """The JAX and torch versions of the inputs: x, B, C in ``dtype``;
    dt, a, D, h0 in f32 (as the Mamba-2 layer gives them)."""
    x, dt, a, Bm, Cm, D, h0 = inputs
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jx = [jnp.asarray(x).astype(jd), jnp.asarray(dt), jnp.asarray(a),
          jnp.asarray(Bm).astype(jd), jnp.asarray(Cm).astype(jd),
          jnp.asarray(D)]
    tx = [torch.from_numpy(x).to(td), torch.from_numpy(dt),
          torch.from_numpy(a), torch.from_numpy(Bm).to(td),
          torch.from_numpy(Cm).to(td), torch.from_numpy(D)]
    return jx, tx, jnp.asarray(h0), torch.from_numpy(h0)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk", SHAPES)
def test_plain_ssd_matches_jax(S, chunk, dtype):
    """y and the final state from a nonzero h0: port chunked and oracle
    against JAX chunked and oracle; y from a zero state against the
    Pallas kernel in interpret mode."""
    jx, tx, jh0, th0 = _split(_ssd_inputs(S, seed=S), dtype)
    tol = TOL[dtype]
    want_y, want_h = _jax_chunked(*jx, h0=jh0, chunk=chunk)
    ref_y, ref_h = _jax_ref(*jx, h0=jh0)
    got_y, got_h = ssm_scan_chunked(*tx, h0=th0, chunk=chunk)
    assert got_y.dtype == tx[0].dtype and got_h.dtype == torch.float32
    for got, want in ((got_y, want_y), (got_h, want_h), (got_y, ref_y),
                      (got_h, ref_h)):
        np.testing.assert_allclose(_np(got), _np(want), **tol)
    oy, oh = ssm_scan_ref(*tx, h0=th0)
    np.testing.assert_allclose(_np(oy), _np(ref_y), **tol)
    np.testing.assert_allclose(_np(oh), _np(ref_h), **tol)

    pallas = jax_pallas(*jx, chunk=chunk, interpret=True)
    np.testing.assert_allclose(
        _np(ssm_scan_chunked(*tx, chunk=chunk)[0]), _np(pallas), **tol)


def test_plain_ssd_vanishing_decay_stays_finite():
    """dt·|a| up to ~100: exp of later-minus-earlier cumulative decays
    overflows to inf above the diagonal, which the intra-chunk mask must
    drop before it meets a zero."""
    jx, tx, jh0, th0 = _split(_ssd_inputs(40, seed=5, dt_scale=40.0),
                              "float32")
    want_y, want_h = _jax_ref(*jx, h0=jh0)
    got_y, got_h = ssm_scan_chunked(*tx, h0=th0, chunk=16)
    assert torch.isfinite(got_y).all() and torch.isfinite(got_h).all()
    np.testing.assert_allclose(_np(got_y), _np(want_y), **TOL["float32"])
    np.testing.assert_allclose(_np(got_h), _np(want_h), **TOL["float32"])


def test_ops_sends_cpu_tensors_to_plain_version():
    _, tx, _, th0 = _split(_ssd_inputs(19, seed=1), "float32")
    got = ops.ssm_scan(*tx, h0=th0, chunk=8)
    want = ssm_scan_chunked(*tx, h0=th0, chunk=8)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_jax(dtype):
    jx, tx, jh0, th0 = _split(_ssd_inputs(1, seed=2), dtype)
    step = [t[:, 0] if t.ndim > 1 else t for t in jx]
    want_y, want_h = jax.jit(jax_decode_step)(jh0, *step)
    got_y, got_h = ssm_decode_step(
        th0, *[t[:, 0] if t.dim() > 1 else t for t in tx])
    assert got_y.dtype == tx[0].dtype
    np.testing.assert_allclose(_np(got_y), _np(want_y), **TOL[dtype])
    np.testing.assert_allclose(_np(got_h), _np(want_h), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(7)
    xBC = rng.standard_normal((B, 9, 12), np.float32)
    w = rng.standard_normal((4, 12), np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    st = rng.standard_normal((B, 3, 12), np.float32) if with_state else None
    want, want_st = jax_mamba2._causal_conv(
        *map(jnp.asarray, (xBC, w, b)),
        None if st is None else jnp.asarray(st))
    got, got_st = causal_conv(*map(torch.from_numpy, (xBC, w, b)),
                              None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got_st), _np(want_st), rtol=0, atol=0)


# ------------------------------------------------------------------ layer
@pytest.fixture(scope="module")
def layer_params():
    """One Mamba-2 layer's JAX weights with dt_bias, A_log, D, the norm
    scale and the conv bias perturbed away from their init constants, so
    that a bias left out, or a scale taken the wrong way, shows."""
    jcfg = jax_get_config("zamba2-2.7b", reduced=True)
    p = jax.tree.map(np.asarray, jax.jit(
        jax_mamba2.init_mamba2, static_argnums=(1, 2))(
        jax.random.PRNGKey(1), jcfg, jnp.float32))
    rng = np.random.default_rng(3)
    for name in ("dt_bias", "A_log", "D", "norm", "conv_b"):
        p[name] = (p[name] + 0.3 * rng.standard_normal(p[name].shape)
                   ).astype(np.float32)
    return p


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
def test_mamba2_layer_matches_jax(layer_params, dtype, tol):
    """Prefill of 21 tokens (two scan chunks and a ragged third) from a
    nonzero state, then two decode steps, each feeding the new state on:
    outputs and states against JAX, held to ``tol`` of their largest
    magnitude (bf16: matmul outputs round at other points in the two
    frameworks)."""
    jcfg = jax_get_config("zamba2-2.7b", reduced=True)
    cfg = get_config("zamba2-2.7b", reduced=True)
    p = layer_params
    layer = Mamba2(cfg, getattr(torch, dtype), "cpu")
    layer.load_state_dict({n: torch.tensor(p[n], dtype=t.dtype)
                           for n, t in layer.state_dict().items()})
    rng = np.random.default_rng(4)
    di, N = cfg.d_inner, cfg.ssm_state
    xs = rng.standard_normal((B, 23, cfg.d_model), np.float32)
    jst = {"conv": jnp.asarray(rng.standard_normal(
        (B, cfg.ssm_conv - 1, di + 2 * N)), jnp.bfloat16),
        "ssm": jnp.asarray(0.3 * rng.standard_normal(
            (B, cfg.ssm_heads, cfg.ssm_head_dim, N)), jnp.float32)}
    tst = {n: torch.tensor(_np(a)).to(torch.bfloat16 if n == "conv"
                                      else torch.float32)
           for n, a in jst.items()}
    jdt = jnp.dtype(dtype)
    japply = jax.jit(lambda x, s, mode: jax_mamba2.mamba2_apply(
        p, x, jcfg, state=s, mode=mode, dtype=jdt), static_argnums=2)

    def close(got, want):
        g, w = _np(got), _np(want)
        assert np.abs(g - w).max() <= tol * np.abs(w).max()

    for lo, hi, mode in ((0, 21, "prefill"), (21, 22, "decode"),
                         (22, 23, "decode")):
        x = xs[:, lo:hi]
        jo, jst = japply(jnp.asarray(x).astype(jdt), jst, mode)
        with torch.no_grad():
            to, tst = layer(torch.from_numpy(x), state=tst, mode=mode,
                            dtype=getattr(torch, dtype))
        close(to, jo)
        assert tst["conv"].dtype == torch.bfloat16
        assert tst["ssm"].dtype == torch.float32
        for n in jst:
            close(tst[n], jst[n])


# ------------------------------------------------------------------- model
@pytest.fixture(scope="module")
def params():
    """JAX init (param_dtype f32, whatever the compute dtype)."""
    jcfg = jax_get_config("zamba2-2.7b", reduced=True)
    return jax.jit(jax_init_model, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))


def _models(params, dtype):
    jcfg = jax_get_config("zamba2-2.7b", reduced=True).replace(dtype=dtype)
    cfg = get_config("zamba2-2.7b", reduced=True).replace(dtype=dtype)
    model = Transformer(cfg, "cpu")
    model.load_state_dict(from_jax_params(
        cfg, jax.tree.map(np.asarray, params)))
    return (jcfg, params), (cfg, model)


@pytest.fixture(scope="module")
def f32(params):
    return _models(params, "float32")


def _flat_caches(jc):
    """The JAX hybrid caches in the port's layout: Mamba states (groups,
    period, ...) → (layers, ...)."""
    return {"mamba": {n: _np(t).reshape(-1, *t.shape[2:])
                      for n, t in jc["mamba"].items()},
            "shared": {n: _np(t) for n, t in jc["shared"].items()}}


def _prefill_decode(jax_side, port_side, toks, n, capacity, cache_dtype,
                    steps=3):
    """Logits of a prefill over toks[:, :n] and ``steps`` decode steps,
    and the final caches, from both frameworks."""
    (jcfg, params), (cfg, model) = jax_side, port_side
    jc = jax_init_caches(jcfg, B, capacity, dtype=getattr(jnp, cache_dtype))
    tc = init_caches(cfg, B, capacity, dtype=getattr(torch, cache_dtype),
                     device="cpu")
    prefill = jax.jit(lambda p, t, c: jax_forward(
        p, jcfg, {"tokens": t}, mode="prefill", caches=c))
    decode = jax.jit(lambda p, t, c, pos: jax_forward(
        p, jcfg, {"tokens": t}, mode="decode", caches=c, pos=pos))
    jl, jc, _ = prefill(params, jnp.asarray(toks[:, :n]), jc)
    with torch.no_grad():
        tl, tc = forward(model, {"tokens": torch.from_numpy(toks[:, :n])},
                         mode="prefill", caches=tc)
    want, got = [_np(jl)], [_np(tl)]
    for i in range(steps):
        step = toks[:, n + i: n + i + 1]
        jl, jc, _ = decode(params, jnp.asarray(step), jc, jnp.asarray(n + i))
        with torch.no_grad():
            tl, tc = forward(model, {"tokens": torch.from_numpy(step)},
                             mode="decode", caches=tc, pos=n + i)
        want.append(_np(jl))
        got.append(_np(tl))
    return want, got, jc, tc


def _tokens(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n))


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_f32_prefill_and_decode_logits_match_jax(f32, cache_dtype):
    """f32 compute: same math, sums in another order → 1e-4, over a
    44-token prefill (longer than the window of 32: the shared block's
    ring cache is written rotated and prefill attention is windowed;
    three SSD chunks, the last ragged) and four decode steps over the
    rotated ring. The caches that result agree too.

    With the bf16 cache, the conv rows and keys/values the two
    frameworks compute ~1e-7 apart are rounded to bf16, and a few of
    them (about 10 in 10^4) land on neighbouring bf16 values, one step
    (2^-8 to 2^-7 of the value) apart; the random model carries that on
    to ~3e-4 of a logit by the fourth step. There the logits and the f32
    SSM states are held to 1e-4 of their largest magnitude, and the bf16
    entries to 2^-8 of theirs."""
    toks = _tokens(f32[1][0], 48)
    want, got, jc, tc = _prefill_decode(*f32, toks, 44, 64, cache_dtype,
                                        steps=4)

    def close(g, w, rel=1e-4):
        if cache_dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
        else:
            assert np.abs(g - w).max() <= rel * np.abs(w).max()

    for w, g in zip(want, got):
        close(g, w)
    for part, tensors in _flat_caches(jc).items():
        for n, want_t in tensors.items():
            got_t = tc[part][n]
            assert got_t.dtype == (torch.float32 if n == "ssm"
                                   else getattr(torch, cache_dtype))
            close(_np(got_t), want_t, 1e-4 if n == "ssm" else 2.0 ** -8)


def test_f32_train_forward_matches_jax(f32):
    (jcfg, params), (cfg, model) = f32
    toks = _tokens(cfg, 40, seed=1)
    want, _, _ = jax_forward(params, jcfg, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, caches = forward(model, {"tokens": torch.from_numpy(toks)})
    assert caches is None
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_bf16_logits_match_jax(params):
    """bf16 compute, default bf16 cache: the frameworks round matmul
    outputs and residual sums to bf16 at different points, so logits
    are held to 2e-2 of the largest |logit|, as for smollm and rwkv6."""
    jax_side, port_side = _models(params, "bfloat16")
    toks = _tokens(port_side[0], 43)
    want, got, _, _ = _prefill_decode(jax_side, port_side, toks, 40, 64,
                                      "bfloat16")
    for w, g in zip(want, got):
        assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max()


def test_cache_shapes(f32):
    """Per Mamba-2 layer the conv rows (cache dtype) and the SSM state
    (f32), a constant size; per group a shared-attention ring capped at
    the window, at the shared block's head width 2·D / heads."""
    cfg = f32[1][0]
    L, G = cfg.n_layers, cfg.n_layers // cfg.hybrid_attn_period
    conv = cfg.d_inner + 2 * cfg.ssm_state
    Dh = 2 * cfg.d_model // cfg.n_heads
    for capacity, cap in ((8, 8), (4096, cfg.window)):
        c = init_caches(cfg, B, capacity, device="cpu")
        got = {f"{part}.{n}": (tuple(t.shape), t.dtype)
               for part, d in c.items() for n, t in d.items()}
        assert got == {
            "mamba.conv": ((L, B, cfg.ssm_conv - 1, conv), torch.bfloat16),
            "mamba.ssm": ((L, B, cfg.ssm_heads, cfg.ssm_head_dim,
                           cfg.ssm_state), torch.float32),
            "shared.k": ((G, B, cap, cfg.n_kv_heads, Dh), torch.bfloat16),
            "shared.v": ((G, B, cap, cfg.n_kv_heads, Dh), torch.bfloat16)}


def test_full_size_cache_shapes():
    """zamba2-2.7b: conv (B, 3, 5248) and SSM (B, 80, 64, 64) per layer,
    a ring of min(capacity, 4096) at 32 KV heads of 160 per group."""
    cfg = get_config("zamba2-2.7b")
    assert (cfg.d_inner, cfg.ssm_heads) == (5120, 80)
    c = init_caches(cfg.replace(n_layers=6), 1, 8192, device="cpu")
    assert tuple(c["mamba"]["conv"].shape) == (6, 1, 3, 5248)
    assert tuple(c["mamba"]["ssm"].shape) == (6, 1, 80, 64, 64)
    assert tuple(c["shared"]["k"].shape) == (1, 1, 4096, 32, 160)


def test_convert_rejects_wrong_depth(f32):
    (_, params), (cfg, _) = f32
    np_params = jax.tree.map(np.asarray, params)
    with pytest.raises(ValueError, match="layers"):
        from_jax_params(cfg.replace(n_layers=cfg.n_layers + 1), np_params)
    with pytest.raises(ValueError, match="groups of"):
        from_jax_params(cfg.replace(hybrid_attn_period=1), np_params)


def test_convert_keeps_f32_where_jax_computes_in_f32(params):
    cfg = get_config("zamba2-2.7b", reduced=True)
    state = from_jax_params(cfg, jax.tree.map(np.asarray, params))
    f32 = {n for n, t in state.items() if t.dtype == torch.float32}
    assert f32 == {"final_norm", "shared.ln1", "shared.ln2"} | {
        f"blocks.{i}.{n}" for i in range(cfg.n_layers)
        for n in ("ln", "mamba.dt_bias", "mamba.A_log", "mamba.D",
                  "mamba.norm")}
    assert state["blocks.3.mamba.in_proj"].dtype == torch.bfloat16
    assert state["shared.attn.wo"].shape == (
        cfg.n_heads, 2 * cfg.d_model // cfg.n_heads, 2 * cfg.d_model)


def test_greedy_tokens_match_jax_engine(f32):
    """f32 weights, the engines' default bf16 cache, waves of 2 with
    left-padding; the second wave is longer than the window: identical
    greedy tokens."""
    (jcfg, params), (cfg, model) = f32
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 19, 40, 36)]
    want = JaxServeEngine(jcfg, params, batch_size=2,
                          capacity=64).generate(prompts, 6)
    got = ServeEngine(cfg, model, batch_size=2, capacity=64,
                      device="cpu").generate(prompts, 6)
    assert got == want
