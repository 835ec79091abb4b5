"""The query offset of the port's flash attention: the plain blockwise
version with ``q_offset`` (query row i at position q_offset + i, a slice
of a longer query such as one rank's rows of a query chunk) against the
JAX package's ``blockwise_attention(q_offset=…)`` on the same numpy
inputs; a slice at its offset equals those rows of the whole query; and
offset 0 is today's call bit for bit. The CUDA kernel's offset runs on
the card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.blockwise import \
    blockwise_attention as jax_blockwise
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.blockwise import blockwise_attention

# f32: the same math, sums in another order (test_torch_flash_attention)
TOL = dict(rtol=3e-5, atol=1.2e-4)

VARIANTS = [
    dict(causal=True),
    dict(causal=True, window=37),
    dict(causal=True, softcap=30.0),
    dict(causal=True, window=64, softcap=50.0),
    dict(causal=False),
]


def _inputs(seed, B=2, Sq=48, Skv=160, H=4, KV=2, dk=32, dv=24):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, dk), np.float32),
            rng.standard_normal((B, Skv, KV, dk), np.float32),
            rng.standard_normal((B, Skv, KV, dv), np.float32))


@pytest.mark.parametrize("kw", VARIANTS)
@pytest.mark.parametrize("q_offset", [17, 112])
def test_q_offset_matches_jax(kw, q_offset):
    """48 query rows at offsets 17 and 112 of 160 keys (GQA, Dk ≠ Dv):
    the port's chunks (32 × 48) against JAX's (16 × 64)."""
    arrays = _inputs(q_offset)
    want = jax_blockwise(*(jnp.asarray(a) for a in arrays),
                         q_offset=q_offset, q_chunk=16, kv_chunk=64, **kw)
    got = blockwise_attention(*map(torch.from_numpy, arrays),
                              q_offset=q_offset, q_chunk=32, kv_chunk=48,
                              **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kw", VARIANTS[:4])
def test_a_slice_at_its_offset_is_those_rows(kw):
    """Rows o … o + w − 1 of a causal self-attention over 160 positions,
    attended as a query of w rows at offset o, equal those rows of the
    whole call (as ``ops.rows_attention`` attends a rank's slices)."""
    q, k, v = map(torch.from_numpy, _inputs(3, Sq=160))
    whole = blockwise_attention(q, k, v, q_chunk=32, kv_chunk=48, **kw)
    for o, w in ((0, 40), (40, 24), (100, 60)):
        part = blockwise_attention(q[:, o:o + w], k, v, q_offset=o,
                                   q_chunk=32, kv_chunk=48, **kw)
        np.testing.assert_allclose(part.numpy(), whole[:, o:o + w].numpy(),
                                   **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_offset_zero_is_the_call_without_it(dtype):
    q, k, v = (t.to(dtype) for t in map(torch.from_numpy, _inputs(5)))
    for kw in VARIANTS:
        assert torch.equal(
            blockwise_attention(q, k, v, q_offset=0, **kw),
            blockwise_attention(q, k, v, **kw))
        assert torch.equal(ops.attention(q, k, v, q_offset=0, **kw),
                           ops.attention(q, k, v, **kw))
