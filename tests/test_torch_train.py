"""The port's training substrate on the CPU against the JAX package: the
synthetic pipeline bit for bit, the schedule and the norms, the fused CE
loss (value and gradients), the losses on logits; the kernels'
``autograd.Function`` plumbing with its forward given the plain version;
microbatch accumulation; the JAX suite's checkpoint and fault-tolerance
cases on the port's ``Checkpointer`` and ``FaultTolerantLoop``; the
training driver end to end and after a restart (``--device cpu
--reduced``). The losses and every parameter's gradient of seven archs,
and three AdamW steps, are in test_torch_train_grads.py."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import Pipeline as JaxPipeline
from repro.data.pipeline import make_pipeline as jax_make_pipeline
from repro.configs import get_config as jax_get_config
from repro.models import loss as jax_loss
from repro.train import optimizer as jax_opt
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, Pipeline, make_pipeline
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.blockwise import blockwise_attention
from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6.chunked import wkv6_chunked
from repro_torch.kernels.ssm_scan import kernel as ssd_kernel
from repro_torch.kernels.ssm_scan import ops as ssd_ops
from repro_torch.kernels.ssm_scan.chunked import ssm_scan_chunked
from repro_torch.launch import train as train_mod
from repro_torch.models import init_model
from repro_torch.models import loss
from repro_torch.runtime import FaultTolerantLoop, StragglerMonitor
from repro_torch.train import adamw, cosine_schedule
from repro_torch.train.optimizer import clip_by_global_norm, global_norm
from repro_torch.train.train_step import init_train_state, make_train_step


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Shapes this small run faster on one intra-op thread than on many,
    and leave the other cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("kind", ["lm", "vlm", "audio"])
def test_pipeline_bit_for_bit(kind):
    base = dict(kind=kind, vocab_size=1000, seq_len=40, global_batch=6,
                seed=7, frontend_dim=12, frontend_tokens=8, n_hosts=2)
    for host in (0, 1):
        got = Pipeline(DataConfig(**base, host_id=host))
        want = JaxPipeline(JaxDataConfig(**base, host_id=host))
        assert got.local_batch == want.local_batch == 3
        for step in (0, 5, 123):
            a, b = got.at(step), want.at(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch", ["smollm-360m", "pixtral-12b",
                                  "hubert-xlarge"])
def test_make_pipeline_matches_jax(arch):
    shape = dict(seq_len=32, global_batch=4)
    got = make_pipeline(get_config(arch, reduced=True), shape, seed=2).at(3)
    want = jax_make_pipeline(jax_get_config(arch, reduced=True), shape,
                             seed=2).at(3)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


# -------------------------------------------------------------- optimizer
def test_cosine_schedule_matches_jax():
    for args in ((1e-3, 10, 100), (3e-3, 0, 7, 0.0), (5e-4, 20, 20)):
        got, want = cosine_schedule(*args), jax_opt.cosine_schedule(*args)
        for step in (0, 1, 9, 10, 11, 20, 55, 99, 100, 150):
            np.testing.assert_allclose(got(step).item(), float(want(step)),
                                       rtol=1e-6)
    lr = cosine_schedule(1e-3, 10, 100)
    assert lr(torch.tensor(0, dtype=torch.int32)).item() == 0.0
    assert lr(10).item() == pytest.approx(1e-3, rel=1e-5)


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((7, 5)).astype(np.float32) * 3,
            "b": {"c": rng.standard_normal(11).astype(np.float32),
                  "d": rng.standard_normal((2, 3, 4)).astype(np.float32)}}
    port = jax.tree.map(torch.from_numpy, tree)
    jtree = jax.tree.map(jnp.asarray, tree)
    np.testing.assert_allclose(global_norm(port).item(),
                               float(jax_opt.global_norm(jtree)), rtol=1e-6)
    for max_norm in (1.0, 100.0):
        got, gn = clip_by_global_norm(port, max_norm)
        want, wn = jax_opt.clip_by_global_norm(jtree, max_norm)
        np.testing.assert_allclose(gn.item(), float(wn), rtol=1e-6)
        for g, w in zip(jax.tree.leaves(jax.tree.map(
                lambda t: t.numpy(), got)), jax.tree.leaves(want)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6)
    clipped, norm = clip_by_global_norm({"a": torch.ones(100) * 10.0}, 1.0)
    assert norm.item() == pytest.approx(100.0)
    assert global_norm(clipped).item() == pytest.approx(1.0, rel=1e-5)


# ------------------------------------------------------------------ loss
def _loss_inputs(B=2, S=33, D=16, Vp=64, V=50, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, D)).astype(np.float32),
            (0.2 * rng.standard_normal((D, Vp))).astype(np.float32),
            rng.integers(0, V, (B, S)).astype(np.int32),
            rng.random((B, S)) < 0.4)


# (chunk, soft-cap, vocab_size, shift, mask)
FUSED_CASES = {
    "chunk8": (8, None, 50, True, False),
    "chunk16_ragged": (16, None, 50, True, False),
    "one_chunk": (64, None, 50, True, False),
    "softcap": (8, 10.0, 50, True, False),
    "unpadded_vocab": (8, None, 64, True, False),
    "mask_no_shift": (8, None, 50, False, True),
    "mask_shift_softcap": (16, 30.0, 50, True, True),
}


@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_lm_loss_value_and_grads_match_jax(case):
    chunk, cap, V, shift, use_mask = FUSED_CASES[case]
    h, w, t, m = _loss_inputs(V=V)
    kw = dict(final_softcap=cap, vocab_size=V, chunk=chunk, shift=shift)
    jm = jnp.asarray(m) if use_mask else None
    (jv, (jdh, jdw)) = jax.jit(jax.value_and_grad(
        lambda h_, w_: jax_loss.fused_lm_loss(
            h_, w_, jnp.asarray(t), mask=jm, **kw), argnums=(0, 1)))(
        jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = loss.fused_lm_loss(th, tw, torch.from_numpy(t).long(),
                             mask=torch.from_numpy(m) if use_mask else None,
                             **kw)
    dh, dw = torch.autograd.grad(got, (th, tw))
    np.testing.assert_allclose(got.item(), float(jv), rtol=1e-5)
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-8)


def test_lm_and_masked_pred_loss_match_jax():
    h, w, t, m = _loss_inputs()
    logits = h @ w
    want = jax.jit(lambda lg, t_, m_: (
        jax_loss.lm_loss(lg, t_), jax_loss.lm_loss(lg, t_, m_),
        jax_loss.masked_pred_loss(lg, t_, m_)))(
            jnp.asarray(logits), jnp.asarray(t), jnp.asarray(m))
    lg, tt, tm = (torch.from_numpy(a) for a in (logits, t, m))
    got = (loss.lm_loss(lg, tt), loss.lm_loss(lg, tt, tm),
           loss.masked_pred_loss(lg, tt, tm))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w_), rtol=1e-6)


# ----------------------------------------- the kernels' autograd.Function
@pytest.fixture
def plain_kernels(monkeypatch):
    """The Functions' forwards given the plain versions, so their
    plumbing runs on the CPU (the raw wrappers take CUDA tensors only)."""
    monkeypatch.setattr(flash_kernel, "flash_attention",
                        lambda q, k, v, **kw: blockwise_attention(
                            q, k, v, **kw))
    monkeypatch.setattr(wkv_kernel, "wkv6", lambda *a, s0=None: wkv6_chunked(
        *a, s0=s0, chunk=8))
    monkeypatch.setattr(ssd_kernel, "ssm_scan",
                        lambda *a, h0=None: ssm_scan_chunked(*a, h0=h0,
                                                             chunk=8))


def _leaves(arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


def _grads_two_ways(fn_kernel, fn_plain, arrays, combine):
    """Gradients of combine(outputs) for every input, through the
    Function and through autograd of the plain version."""
    out = []
    for fn in (fn_kernel, fn_plain):
        xs = _leaves(arrays)
        val = combine(fn(*xs))
        out.append(torch.autograd.grad(val, xs))
    return out


@pytest.mark.parametrize("shared_kv", [False, True])
def test_flash_function_grads_equal_plain(plain_kernels, shared_kv):
    rng = np.random.default_rng(0)
    B, S, H, KV, D = 2, 19, 4, 2, 8
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    kv = rng.standard_normal((B, S, KV, 2 * D)).astype(np.float32)
    w = rng.standard_normal((B, S, H, D)).astype(np.float32)
    kw = dict(causal=True, window=7, softcap=5.0, q_chunk=8, kv_chunk=8)

    def split(kv):   # MLA: the value is a view of the key's columns
        return (kv[..., :D], kv[..., :D]) if shared_kv else (
            kv[..., :D], kv[..., D:])

    got, want = _grads_two_ways(
        lambda q, kv: flash_ops.kernel_attention(q, *split(kv), **kw),
        lambda q, kv: blockwise_attention(q, *split(kv), **kw),
        [q, kv], lambda o: (o * torch.from_numpy(w)).sum())
    for g, ww in zip(got, want):
        torch.testing.assert_close(g, ww, rtol=1e-6, atol=1e-6)
    if shared_kv:
        assert got[1][..., D:].abs().max() == 0


@pytest.mark.parametrize("use_state", [False, True])
def test_wkv6_function_grads_equal_plain(plain_kernels, use_state):
    rng = np.random.default_rng(1)
    B, S, H, K = 2, 13, 2, 4
    r, k, v = (rng.standard_normal((B, S, H, K)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.5, 0.99, (B, S, H, K)).astype(np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32)
    s0 = rng.standard_normal((B, H, K, K)).astype(np.float32)

    def combine(out):   # the final state unused: its gradient is None
        y, s = out
        return (y * y).sum() + ((s * s).sum() if use_state else 0.0)

    got, want = _grads_two_ways(
        lambda *a: wkv_ops.kernel_wkv6(*a[:5], s0=a[5], chunk=8),
        lambda *a: wkv6_chunked(*a[:5], s0=a[5], chunk=8),
        [r, k, v, w, u, s0], combine)
    for g, ww in zip(got, want):
        torch.testing.assert_close(g, ww, rtol=1e-6, atol=1e-6)
        assert g.abs().max() > 0


@pytest.mark.parametrize("use_state", [False, True])
def test_ssd_function_grads_equal_plain(plain_kernels, use_state):
    rng = np.random.default_rng(2)
    B, S, H, P, G, N = 2, 13, 4, 4, 2, 8
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.1, 1.0, (B, S, H)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, H).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, G, N)).astype(np.float32)
              for _ in range(2))
    D = rng.standard_normal(H).astype(np.float32)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32)

    def combine(out):
        y, h = out
        return (y * y).sum() + ((h * h).sum() if use_state else 0.0)

    got, want = _grads_two_ways(
        lambda *a_: ssd_ops.kernel_ssm_scan(*a_[:6], h0=a_[6], chunk=8),
        lambda *a_: ssm_scan_chunked(*a_[:6], h0=a_[6], chunk=8),
        [x, dt, a, Bm, Cm, D, h0], combine)
    for g, ww in zip(got, want):
        torch.testing.assert_close(g, ww, rtol=1e-6, atol=1e-6)
        assert g.abs().max() > 0


def test_plain_versions_have_finite_grads_where_decays_vanish():
    """Chunks long enough, and decays strong enough, that exp of the
    masked (j > i) exponents overflows f32: the values and every gradient
    stay finite (a where() after the exp would give 0 · inf = NaN in the
    backward)."""
    rng = np.random.default_rng(3)
    B, S, H, P, N = 1, 64, 2, 4, 8
    x, Bm, Cm = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((B, S, H, P), (B, S, 1, N), (B, S, 1, N)))
    dt = torch.full((B, S, H), 3.0)
    a = torch.full((H,), -2.0)          # dt·a = −6 a step: exp(+378)
    D = torch.ones(H)
    xs = [t.requires_grad_() for t in (x, dt, a, Bm, Cm, D)]
    y, h = ssm_scan_chunked(*xs, chunk=64)
    grads = torch.autograd.grad(y.sum() + h.sum(), xs)
    assert all(torch.isfinite(g).all() for g in grads)
    K = 4
    r, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, K)).astype(
        np.float32)).requires_grad_() for _ in range(3))
    w = torch.full((B, S, H, K), 1e-3, requires_grad=True)  # log w ≈ −6.9
    u = torch.zeros(H, K, requires_grad=True)
    y, s = wkv6_chunked(r, k, v, w, u, chunk=32)
    grads = torch.autograd.grad(y.sum() + s.sum(), (r, k, v, w, u))
    assert torch.isfinite(y).all()
    assert all(torch.isfinite(g).all() for g in grads)


def test_raw_wrappers_refuse_inputs_that_require_grad():
    q = torch.zeros(1, 4, 2, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        flash_kernel.flash_attention(q, q, q)
    r = torch.zeros(1, 4, 2, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        wkv_kernel.wkv6(r, r, r, r, torch.zeros(2, 16))
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(RuntimeError, match="requires grad"):
        ssd_kernel.ssm_scan(x, torch.zeros(1, 4, 2), torch.zeros(2),
                            torch.zeros(1, 4, 1, 8), torch.zeros(1, 4, 1, 8),
                            torch.zeros(2, requires_grad=True))


# ------------------------------------------- train step, checkpoint, loop
def tiny_setup(accum=1):
    cfg = get_config("smollm-360m", reduced=True)
    model = init_model(cfg, seed=0, device="cpu", train=True)
    opt = adamw(lr=5e-3, weight_decay=0.0)
    state = init_train_state(dict(model.named_parameters()), opt)
    step = make_train_step(cfg, opt, accum_steps=accum)
    pipe = Pipeline(DataConfig(kind="lm", vocab_size=cfg.vocab_size,
                               seq_len=32, global_batch=8))
    return cfg, state, step, pipe


def test_train_model_keeps_f32_masters_that_require_grad():
    cfg = get_config("smollm-360m", reduced=True)
    train = init_model(cfg, seed=0, device="cpu", train=True)
    serve = init_model(cfg, seed=0, device="cpu")
    for (n, p), (_, s) in zip(train.named_parameters(),
                              serve.named_parameters()):
        assert p.dtype == torch.float32 and p.requires_grad, n
        assert not s.requires_grad, n
        torch.testing.assert_close(p.to(s.dtype), s, rtol=0, atol=0)


def test_accumulation_matches_full_batch():
    """Microbatched gradients equal the full batch's (loss and global
    grad norm; per-parameter comparison is ill-conditioned through Adam's
    step-1 sign normalisation), as in the JAX suite."""
    cfg, state, _, pipe = tiny_setup()
    opt = adamw(lr=5e-3, weight_decay=0.0)
    s1 = make_train_step(cfg, opt, accum_steps=1)
    s4 = make_train_step(cfg, opt, accum_steps=4)
    st1, m1 = s1(state, pipe.at(0))
    st4, m4 = s4(state, pipe.at(0))
    assert m1["loss"].item() == pytest.approx(m4["loss"].item(), rel=1e-5)
    assert m1["grad_norm"].item() == pytest.approx(m4["grad_norm"].item(),
                                                   rel=1e-4)
    _, m1b = s1(st1, pipe.at(1))
    _, m4b = s4(st4, pipe.at(1))
    assert m1b["loss"].item() == pytest.approx(m4b["loss"].item(), rel=5e-3)


def test_step_leaves_its_input_state_unchanged():
    _, state, step, pipe = tiny_setup()
    before = {n: p.clone() for n, p in state["params"].items()}
    new, _ = step(state, pipe.at(0))
    assert int(new["step"]) == 1 and int(new["opt"]["count"]) == 1
    assert int(state["step"]) == 0
    for n, p in state["params"].items():
        torch.testing.assert_close(p, before[n], rtol=0, atol=0)


def test_checkpoint_roundtrip(tmp_path):
    _, state, step, pipe = tiny_setup()
    state, _ = step(state, pipe.at(0))
    ck = Checkpointer(str(tmp_path))
    ck.save(state, 1)
    restored, rs = ck.restore(device="cpu")
    assert rs == 1
    assert sorted(restored) == ["opt", "params", "step"]
    for tree in ("params",):
        for n, p in state[tree].items():
            torch.testing.assert_close(restored[tree][n], p, rtol=0, atol=0)
    assert int(restored["opt"]["count"]) == 1
    assert restored["opt"]["count"].dtype == torch.int32


def test_checkpoint_keeps_bf16(tmp_path):
    t = torch.randn(3, 5).to(torch.bfloat16)
    ck = Checkpointer(str(tmp_path))
    ck.save({"w": t, "n": {"c": torch.tensor(3)}}, 2)
    got, _ = ck.restore()
    assert got["w"].dtype == torch.bfloat16
    torch.testing.assert_close(got["w"], t, rtol=0, atol=0)
    assert int(got["n"]["c"]) == 3


def test_checkpoint_gc_and_latest(tmp_path):
    _, state, _, _ = tiny_setup()
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(state, s)
    assert ck.steps() == [3, 4]
    assert ck.latest() == 4


def test_checkpoint_background_save(tmp_path):
    _, state, _, _ = tiny_setup()
    ck = Checkpointer(str(tmp_path))
    ck.save(state, 7, background=True)
    ck.wait()
    assert ck.latest() == 7


def test_ft_loop_rejects_nan_steps(tmp_path):
    _, state, step, pipe = tiny_setup()
    calls = {"n": 0}

    def flaky_step(st, batch):
        calls["n"] += 1
        st, m = step(st, batch)
        if calls["n"] == 3:          # poison one step
            m = dict(m)
            m["loss"] = torch.tensor(float("nan"))
        return st, m

    loop = FaultTolerantLoop(flaky_step, pipe, Checkpointer(str(tmp_path)),
                             ckpt_every=100, log=lambda *_: None)
    state, report = loop.run(state, 0, 10)
    assert report.bad_steps == 1
    assert report.steps_run == 9
    assert all(math.isfinite(x) for x in report.losses)


def test_ft_loop_retries_exceptions(tmp_path):
    _, state, step, pipe = tiny_setup()
    calls = {"n": 0}

    def crashy(st, batch):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated device failure")
        return step(st, batch)

    loop = FaultTolerantLoop(crashy, pipe, None, log=lambda *_: None)
    state, report = loop.run(state, 0, 5)
    assert report.retries == 1
    assert report.steps_run == 5
    assert int(state["step"]) == 5


def test_ft_loop_restores_after_repeated_failures(tmp_path):
    _, state, step, pipe = tiny_setup()
    ck = Checkpointer(str(tmp_path))
    ck.save(state, 0)
    calls = {"n": 0}

    def dying(st, batch):
        calls["n"] += 1
        if 2 <= calls["n"] <= 4:
            raise RuntimeError("simulated device failure")
        return step(st, batch)

    loop = FaultTolerantLoop(dying, pipe, ck, ckpt_every=100,
                             log=lambda *_: None, device="cpu")
    state, report = loop.run(state, 0, 3)
    assert report.restores == 1
    assert report.steps_run == 3


def test_straggler_monitor():
    mon = StragglerMonitor(threshold=2.0, alpha=0.5)
    for i in range(5):
        assert not mon.observe(i, 1.0)
    assert mon.observe(5, 5.0)
    assert mon.flagged == [(5, 5.0)]
    assert mon.ewma == pytest.approx(1.0)


# ------------------------------------------------------------------ driver
def test_train_driver_end_to_end(tmp_path):
    report = train_mod.main([
        "--arch", "smollm-360m", "--reduced", "--steps", "12",
        "--batch", "4", "--seq", "48", "--lr", "3e-3",
        "--ckpt", str(tmp_path), "--ckpt-every", "5",
        "--log-every", "6", "--device", "cpu",
    ])
    assert report.steps_run == 12
    assert report.losses[-1] < report.losses[0]
    assert Checkpointer(str(tmp_path)).steps() == [5, 10, 12]


def test_train_driver_restart_resumes(tmp_path, capsys):
    train_mod.main([
        "--arch", "smollm-360m", "--reduced", "--steps", "6",
        "--batch", "4", "--seq", "48", "--ckpt", str(tmp_path),
        "--ckpt-every", "3", "--log-every", "100", "--device", "cpu",
    ])
    report = train_mod.main([
        "--arch", "smollm-360m", "--reduced", "--steps", "4",
        "--batch", "4", "--seq", "48", "--ckpt", str(tmp_path),
        "--restore", "auto", "--log-every", "100", "--device", "cpu",
    ])
    assert report.steps_run == 4
    assert report.restores == 0
    assert "[train] restored step 6" in capsys.readouterr().out
    assert Checkpointer(str(tmp_path)).latest() == 10
