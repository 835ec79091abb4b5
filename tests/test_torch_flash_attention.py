"""Port flash attention (plain blockwise version and O(S²) oracle) against
the JAX package's Pallas kernel (interpret mode) and its oracle, on the
same numpy inputs. The CUDA kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py); its bf16 numerics,
P rounded to bf16 for the tensor cores, are checked here."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import \
    flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.blockwise import (
    NEG_INF, blockwise_attention)
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

# f32: same math, sums in another order; bf16: one output rounding apart.
TOL = {"float32": dict(rtol=3e-5, atol=1.2e-4),
       "bfloat16": dict(rtol=2e-2, atol=8e-2)}

# chip_smoke.py's limit for the kernel against the plain version at
# smollm-360m's prefill shape in bf16.
SMOLLM_BF16_TOL = dict(rtol=1e-2, atol=5e-3)

VARIANTS = [
    dict(causal=True),
    dict(causal=False),
    dict(causal=True, window=37),
    dict(causal=True, softcap=30.0),
    dict(causal=True, window=64, softcap=50.0),
]


def _inputs(seed, B, Sq, Skv, H, KV, dk, dv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, dk), np.float32),
            rng.standard_normal((B, Skv, KV, dk), np.float32),
            rng.standard_normal((B, Skv, KV, dv), np.float32))


def _both(arrays, dtype):
    jx = [jnp.asarray(a).astype(dtype) for a in arrays]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tt


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])


def _check(arrays, dtype, **kw):
    (jq, jk, jv), (q, k, v) = _both(arrays, dtype)
    want = jax_flash(jq, jk, jv, bq=64, bk=64, interpret=True, **kw)
    got = blockwise_attention(q, k, v, q_chunk=32, kv_chunk=48, **kw)
    _close(got, want, dtype)
    _close(attention_ref(q, k, v, **kw), jax_ref(jq, jk, jv, **kw), dtype)
    _close(got, jax_ref(jq, jk, jv, **kw), dtype)


@pytest.mark.parametrize("kwargs", VARIANTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blockwise_matches_pallas_variants(kwargs, dtype):
    _check(_inputs(0, 2, 130, 130, 4, 2, 32, 32), dtype, **kwargs)


def test_blockwise_matches_pallas_mla_shape():
    """MLA absorbed form: Dk != Dv, MQA (KV=1), custom scale."""
    _check(_inputs(1, 2, 96, 96, 8, 1, 80, 64), "float32", causal=True,
           scale=0.125)


@pytest.mark.parametrize("sq,skv,causal", [(77, 77, True), (50, 77, False)])
def test_blockwise_matches_pallas_ragged(sq, skv, causal):
    _check(_inputs(2, 1, sq, skv, 4, 2, 16, 16), "float32", causal=causal)


def test_kernel_wrapper_rejects_cpu_tensor():
    q, k, v = _both(_inputs(3, 1, 8, 8, 2, 1, 16, 16), "float32")[1]
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v)


def test_ops_cpu_takes_plain_path():
    q, k, v = _both(_inputs(4, 1, 40, 40, 2, 1, 16, 16), "float32")[1]
    before = flash_attention.launches
    got = ops.attention(q, k, v, causal=True, window=9, q_chunk=16,
                        kv_chunk=32)
    assert flash_attention.launches == before
    want = blockwise_attention(q, k, v, causal=True, window=9, q_chunk=16,
                               kv_chunk=32)
    assert torch.equal(got, want)


def _attention_p_bf16(q, k, v, *, causal=True, window=None, softcap=None,
                      scale=None, kv_chunk=64):
    """``blockwise_attention`` as the CUDA kernel's bf16 path computes it:
    P rounded to bf16 before P·V (the tensor cores take bf16 operands),
    the running sum l taken over the f32 P; 64-key tiles, as the kernel
    takes at head dims up to 160."""
    B, Sq, H, Dk = q.shape
    Skv, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KV
    scale = 1.0 / math.sqrt(Dk) if scale is None else scale
    qf = q.float().reshape(B, Sq, KV, G, Dk)
    qpos = torch.arange(Sq)[:, None]
    acc = torch.zeros(B, KV, G, Sq, Dv)
    m = torch.full((B, KV, G, Sq), NEG_INF)
    l = torch.zeros(B, KV, G, Sq)
    for k0 in range(0, Skv, kv_chunk):
        kb, vb = (t[:, k0:k0 + kv_chunk].float() for t in (k, v))
        kpos = torch.arange(k0, k0 + kb.shape[1])[None, :]
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kb) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        msk = torch.ones(Sq, kb.shape[1], dtype=torch.bool)
        if causal:
            msk &= kpos <= qpos
        if window is not None:
            msk &= kpos > qpos - window
        s = torch.where(msk, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.bfloat16().float(), vb)
        m = m_new
    o = acc / torch.clamp_min(l[..., None], 1e-37)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv).to(q.dtype)


@pytest.mark.parametrize("kwargs", VARIANTS)
def test_p_in_bf16_matches_pallas_variants(kwargs):
    """The kernel's bf16 P against the JAX Pallas kernel (interpret mode)
    at the JAX suite's bf16 limit."""
    (jq, jk, jv), (q, k, v) = _both(_inputs(0, 2, 130, 130, 4, 2, 32, 32),
                                    "bfloat16")
    want = jax_flash(jq, jk, jv, bq=64, bk=64, interpret=True, **kwargs)
    _close(_attention_p_bf16(q, k, v, **kwargs), want, "bfloat16")


def test_p_in_bf16_within_smollm_limit():
    """The kernel's bf16 P against the plain version at smollm-360m's
    widths (GQA 15:5, head dim 64, causal, unit-normal inputs) within
    chip_smoke.py's limit for the kernel there: rounding P to bf16 needs
    no hi/lo split."""
    (q, k, v) = _both(_inputs(5, 1, 256, 256, 15, 5, 64, 64), "bfloat16")[1]
    got = _attention_p_bf16(q, k, v, causal=True)
    want = blockwise_attention(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), **SMOLLM_BF16_TOL)
