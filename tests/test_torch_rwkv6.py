"""Port RWKV-6 (plain WKV, layers, reduced rwkv6-3b model, serving)
against the JAX package on the same numpy inputs and converted weights.
The CUDA kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.rwkv6.chunked import wkv6_chunked as jax_chunked
from repro.kernels.rwkv6.chunked import wkv6_decode_step as jax_decode_step
from repro.kernels.rwkv6.kernel import wkv6 as jax_pallas
from repro.kernels.rwkv6.ref import wkv6_ref as jax_ref
from repro.models import forward as jax_forward
from repro.models import init_caches as jax_init_caches
from repro.models import init_model as jax_init_model
from repro.models.layers import rwkv6 as jax_layers
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.kernels.rwkv6 import ops
from repro_torch.kernels.rwkv6.chunked import wkv6_chunked, wkv6_decode_step
from repro_torch.kernels.rwkv6.ref import wkv6_ref
from repro_torch.models import Transformer, forward, init_caches
from repro_torch.models.convert import from_jax_params
from repro_torch.models.layers.rwkv6 import ChannelMix, TimeMix
from repro_torch.serve import ServeEngine

# The JAX suite's own WKV limits (tests/test_kernels.py): f32 sums in
# another order and through exp/log of the decays; bf16 one output
# rounding apart.
TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
       "bfloat16": dict(rtol=6e-2, atol=6e-2)}
SHAPES = [(32, 16), (70, 16), (128, 32)]     # (S, chunk); B=2, H=3, K=16
B = 2

_jax_chunked = jax.jit(jax_chunked, static_argnames="chunk")
_jax_ref = jax.jit(jax_ref)


def _wkv_inputs(S, seed, B=2, H=3, K=16):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, K), np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(0.5 * rng.standard_normal((B, S, H, K),
                                                 np.float32)))
    u = 0.3 * rng.standard_normal((H, K), np.float32)
    s0 = 0.3 * rng.standard_normal((B, H, K, K), np.float32)
    return (r, k, v, w.astype(np.float32)), u, s0


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk", SHAPES)
def test_plain_wkv_matches_jax(S, chunk, dtype):
    """y and the final state from a nonzero s0: port chunked and oracle
    against JAX chunked and oracle; y from a zero state against the
    Pallas kernel in interpret mode."""
    rkvw, u, s0 = _wkv_inputs(S, seed=S)
    jx = [jnp.asarray(a).astype(dtype) for a in rkvw]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in rkvw]
    ju, js0 = jnp.asarray(u), jnp.asarray(s0)
    tu, ts0 = torch.from_numpy(u), torch.from_numpy(s0)
    tol = TOL[dtype]

    want_y, want_s = _jax_chunked(*jx, ju, js0, chunk=chunk)
    ref_y, ref_s = _jax_ref(*jx, ju, js0)
    got_y, got_s = wkv6_chunked(*tt, tu, s0=ts0, chunk=chunk)
    assert got_y.dtype == tt[0].dtype and got_s.dtype == torch.float32
    for got, want in ((got_y, want_y), (got_s, want_s), (got_y, ref_y),
                      (got_s, ref_s)):
        np.testing.assert_allclose(_np(got), _np(want), **tol)
    oy, os_ = wkv6_ref(*tt, tu, s0=ts0)
    np.testing.assert_allclose(_np(oy), _np(ref_y), **tol)
    np.testing.assert_allclose(_np(os_), _np(ref_s), **tol)

    pallas = jax_pallas(*jx, ju, chunk=chunk, interpret=True)
    np.testing.assert_allclose(
        _np(wkv6_chunked(*tt, tu, chunk=chunk)[0]), _np(pallas), **tol)


def test_plain_wkv_vanishing_decay_stays_finite():
    """w = 0 on a quarter of the entries: the log-decay clamps at
    log(1e-38), so exponents of later-minus-earlier steps overflow to
    inf, which the intra-chunk mask must drop before it meets a zero."""
    (r, k, v, w), u, s0 = _wkv_inputs(40, seed=5)
    w = np.where(np.random.default_rng(6).random(w.shape) < 0.25, 0.0,
                 w).astype(np.float32)
    want_y, want_s = _jax_ref(*map(jnp.asarray, (r, k, v, w, u, s0)))
    got_y, got_s = wkv6_chunked(*map(torch.from_numpy, (r, k, v, w, u)),
                                s0=torch.from_numpy(s0), chunk=16)
    assert torch.isfinite(got_y).all() and torch.isfinite(got_s).all()
    np.testing.assert_allclose(_np(got_y), _np(want_y), **TOL["float32"])
    np.testing.assert_allclose(_np(got_s), _np(want_s), **TOL["float32"])


def test_ops_sends_cpu_tensors_to_plain_version():
    rkvw, u, s0 = _wkv_inputs(19, seed=1)
    tt = [torch.from_numpy(a) for a in rkvw]
    got = ops.wkv6(*tt, torch.from_numpy(u), s0=torch.from_numpy(s0),
                   chunk=8)
    want = wkv6_chunked(*tt, torch.from_numpy(u), s0=torch.from_numpy(s0),
                        chunk=8)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_jax(dtype):
    rkvw, u, s0 = _wkv_inputs(1, seed=2)
    jx = [jnp.asarray(a[:, 0]).astype(dtype) for a in rkvw]
    tt = [torch.from_numpy(a[:, 0]).to(getattr(torch, dtype)) for a in rkvw]
    want_y, want_s = jax.jit(jax_decode_step)(jnp.asarray(s0), *jx,
                                              jnp.asarray(u))
    got_y, got_s = wkv6_decode_step(torch.from_numpy(s0), *tt,
                                    torch.from_numpy(u))
    np.testing.assert_allclose(_np(got_y), _np(want_y), **TOL[dtype])
    np.testing.assert_allclose(_np(got_s), _np(want_s), rtol=1e-6,
                               atol=1e-6)


# ------------------------------------------------------------------ layers
@pytest.fixture(scope="module")
def layer_params():
    """One block's JAX weights with every mix, decay, bonus and ln_x
    perturbed away from its init constant, so that a scale taken as an
    offset from 1, or a mix read from the wrong row, shows."""
    jcfg = jax_get_config("rwkv6-3b", reduced=True)
    p = jax.tree.map(np.asarray, jax.jit(
        jax_layers.init_rwkv6, static_argnums=(1, 2))(
        jax.random.PRNGKey(1), jcfg, jnp.float32))
    rng = np.random.default_rng(3)
    for name in ("mu_base", "cmix_mu", "w0", "ln_x"):
        p[name] = (p[name] + 0.2 * rng.standard_normal(p[name].shape)
                   ).astype(np.float32)
    return p


def _layer(cls, cfg, p, dtype):
    mod = cls(cfg, getattr(torch, dtype), "cpu")
    mod.load_state_dict({n: torch.tensor(p[n], dtype=t.dtype)
                         for n, t in mod.state_dict().items()})
    return mod


@pytest.mark.parametrize("dtype,tol,wkv_tol", [("float32", 1e-4, 1e-4),
                                               ("bfloat16", 2e-2, 1e-3)])
def test_time_and_channel_mix_match_jax(layer_params, dtype, tol, wkv_tol):
    """Prefill of 21 tokens from a nonzero state, then two decode steps,
    each feeding the new state on: outputs and states against JAX, held
    to ``tol`` of their largest magnitude (bf16: matmul outputs round at
    other points in the two frameworks). The WKV state is f32 built from
    the same bf16 r/k/v/w in both (reading ~1e-7 of its largest value);
    leaving w unrounded before the WKV moves it by ~4e-3, so it is held
    to ``wkv_tol``."""
    jcfg = jax_get_config("rwkv6-3b", reduced=True)
    cfg = get_config("rwkv6-3b", reduced=True)
    p = layer_params
    time, chan = (_layer(c, cfg, p, dtype) for c in (TimeMix, ChannelMix))
    rng = np.random.default_rng(4)
    D, H, K = cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_dim
    xs = rng.standard_normal((B, 23, D), np.float32)
    state = {"shift_t": rng.standard_normal((B, D), np.float32),
             "shift_c": rng.standard_normal((B, D), np.float32),
             "wkv": 0.3 * rng.standard_normal((B, H, K, K), np.float32)}
    jt = {n: jnp.asarray(a, jnp.float32 if n == "wkv" else jnp.bfloat16)
          for n, a in state.items()}
    tt = {n: torch.tensor(_np(a)).to(
        torch.float32 if n == "wkv" else torch.bfloat16)
        for n, a in jt.items()}
    jdt = jnp.dtype(dtype)
    jtime = jax.jit(lambda x, s, mode: jax_layers.rwkv6_time_mix(
        p, x, jcfg, state=s, mode=mode, dtype=jdt), static_argnums=2)
    jchan = jax.jit(lambda x, s, mode: jax_layers.rwkv6_channel_mix(
        p, x, jcfg, state=s, mode=mode, dtype=jdt), static_argnums=2)

    def close(got, want, tol=tol):
        g, w = _np(got), _np(want)
        assert np.abs(g - w).max() <= tol * np.abs(w).max()

    for lo, hi, mode in ((0, 21, "prefill"), (21, 22, "decode"),
                         (22, 23, "decode")):
        x = xs[:, lo:hi]
        jo, jn = jtime(jnp.asarray(x).astype(jdt),
                       {"shift_t": jt["shift_t"], "wkv": jt["wkv"]}, mode)
        jc, jcn = jchan(jnp.asarray(x).astype(jdt),
                        {"shift_c": jt["shift_c"]}, mode)
        with torch.no_grad():
            to, tn = time(torch.from_numpy(x), state={
                "shift_t": tt["shift_t"], "wkv": tt["wkv"]}, mode=mode,
                dtype=getattr(torch, dtype))
            tc, tcn = chan(torch.from_numpy(x), state={
                "shift_c": tt["shift_c"]}, mode=mode,
                dtype=getattr(torch, dtype))
        close(to, jo)
        close(tc, jc)
        jt, tt = {**jn, **jcn}, {**tn, **tcn}
        assert tt["shift_t"].dtype == tt["shift_c"].dtype == torch.bfloat16
        for n in jt:
            close(tt[n], jt[n], wkv_tol if n == "wkv" else tol)


# ------------------------------------------------------------------- model
@pytest.fixture(scope="module")
def params():
    """JAX init (param_dtype f32, whatever the compute dtype)."""
    jcfg = jax_get_config("rwkv6-3b", reduced=True)
    return jax.jit(jax_init_model, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))


def _models(params, dtype):
    jcfg = jax_get_config("rwkv6-3b", reduced=True).replace(dtype=dtype)
    cfg = get_config("rwkv6-3b", reduced=True).replace(dtype=dtype)
    model = Transformer(cfg, "cpu")
    model.load_state_dict(from_jax_params(
        cfg, jax.tree.map(np.asarray, params)))
    return (jcfg, params), (cfg, model)


@pytest.fixture(scope="module")
def f32(params):
    return _models(params, "float32")


def _prefill_decode(jax_side, port_side, toks, n, cache_dtype, steps=3):
    """Logits of a prefill over toks[:, :n] and ``steps`` decode steps,
    and the final caches, from both frameworks."""
    (jcfg, params), (cfg, model) = jax_side, port_side
    jc = jax_init_caches(jcfg, B, 8, dtype=getattr(jnp, cache_dtype))
    tc = init_caches(cfg, B, 8, dtype=getattr(torch, cache_dtype),
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
    37-token prefill (two WKV chunks and a ragged third) and four decode
    steps. With the default bf16 cache the token shifts are rounded to
    bf16 between steps, in both frameworks."""
    toks = _tokens(f32[1][0], 41)
    want, got, jc, tc = _prefill_decode(*f32, toks, 37, cache_dtype,
                                        steps=4)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    for n, t in tc["layers"].items():
        assert t.dtype == (torch.float32 if n == "wkv"
                           else getattr(torch, cache_dtype))
        np.testing.assert_allclose(_np(t), _np(jc["layers"][n]), rtol=1e-4,
                                   atol=1e-4)


def test_f32_train_forward_matches_jax(f32):
    (jcfg, params), (cfg, model) = f32
    toks = _tokens(cfg, 33, seed=1)
    want, _, _ = jax_forward(params, jcfg, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, caches = forward(model, {"tokens": torch.from_numpy(toks)})
    assert caches is None
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_bf16_logits_match_jax(params):
    """bf16 compute, default bf16 cache: the frameworks round matmul
    outputs and residual sums to bf16 at different points, so logits
    are held to 2e-2 of the largest |logit|, as for smollm."""
    jax_side, port_side = _models(params, "bfloat16")
    toks = _tokens(port_side[0], 24)
    want, got, _, _ = _prefill_decode(jax_side, port_side, toks, 21,
                                      "bfloat16")
    for w, g in zip(want, got):
        assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max()


def test_cache_has_constant_size(f32):
    cfg = f32[1][0]
    small, large = (init_caches(cfg, B, c, device="cpu") for c in (8, 4096))
    H, K, D, L = cfg.rwkv_heads, cfg.rwkv_head_dim, cfg.d_model, cfg.n_layers
    for c in (small, large):
        assert {n: (tuple(t.shape), t.dtype) for n, t in
                c["layers"].items()} == {
            "shift_t": ((L, B, D), torch.bfloat16),
            "shift_c": ((L, B, D), torch.bfloat16),
            "wkv": ((L, B, H, K, K), torch.float32)}


def test_convert_rejects_wrong_depth(f32):
    (_, params), (cfg, _) = f32
    with pytest.raises(ValueError, match="layers"):
        from_jax_params(cfg.replace(n_layers=cfg.n_layers + 1),
                        jax.tree.map(np.asarray, params))


def test_convert_keeps_f32_where_jax_computes_in_f32(params):
    cfg = get_config("rwkv6-3b", reduced=True)
    state = from_jax_params(cfg, jax.tree.map(np.asarray, params))
    f32 = {n.split(".", 2)[2] for n, t in state.items()
           if n.startswith("blocks.0.") and t.dtype == torch.float32}
    assert f32 == {"ln1", "ln2", "time.w0", "time.decay_A", "time.decay_B",
                   "time.u", "time.ln_x"}
    assert state["final_norm"].dtype == torch.float32
    assert state["blocks.0.time.wr"].dtype == torch.bfloat16


def test_greedy_tokens_match_jax_engine(f32):
    """f32 weights, the engines' default bf16 cache, waves of 2 with
    left-padding (the pad tokens enter the recurrence in both):
    identical greedy tokens."""
    (jcfg, params), (cfg, model) = f32
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 19, 3, 7)]
    want = JaxServeEngine(jcfg, params, batch_size=2,
                          capacity=64).generate(prompts, 6)
    got = ServeEngine(cfg, model, batch_size=2, capacity=64,
                      device="cpu").generate(prompts, 6)
    assert got == want
