"""Port flash attention (plain blockwise version and O(S²) oracle) against
the JAX package's Pallas kernel (interpret mode) and its oracle, on the
same numpy inputs. The CUDA kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import \
    flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.blockwise import blockwise_attention
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

# f32: same math, sums in another order; bf16: one output rounding apart.
TOL = {"float32": dict(rtol=3e-5, atol=1.2e-4),
       "bfloat16": dict(rtol=2e-2, atol=8e-2)}

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
