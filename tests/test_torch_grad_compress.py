"""The port's int8 error-feedback gradient all-reduce
(``repro_torch.train.grad_compress``) against the JAX package's
``repro.train.grad_compress``: the quantiser and the error feedback bit
for bit on the same numpy inputs, and a 4-rank gloo all-reduce against
the mean of JAX's per-rank ``compress_residual`` (each rank's residual
bit for bit). The world runs in a subprocess of its own."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.grad_compress import compress_residual as jax_compress
from repro.train.grad_compress import quantize_int8 as jax_quantize
from repro_torch.train.grad_compress import (compress_residual,
                                             dequantize_int8, quantize_int8)

from _torch_dist import gloo_world


def _draw(seed, shape=(37, 19), scale=3.0):
    rng = np.random.default_rng(seed)
    g = (scale * rng.standard_normal(shape)).astype(np.float32)
    err = (0.01 * rng.standard_normal(shape)).astype(np.float32)
    return g, err


@pytest.mark.parametrize("case", ["normal", "zeros", "tiny", "bf16"])
def test_quantize_and_error_feedback_bit_for_bit(case):
    g, err = _draw(1)
    if case == "zeros":
        g, err = np.zeros_like(g), np.zeros_like(err)
    if case == "tiny":
        g = g * 1e-30
    if case == "bf16":
        g = np.asarray(jnp.asarray(g).astype(jnp.bfloat16).astype(
            jnp.float32))
    jq, js = jax_quantize(jnp.asarray(g))
    q, s = quantize_int8(torch.from_numpy(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)
    jq, js, je = jax_compress(jnp.asarray(g), jnp.asarray(err))
    q, s, e = compress_residual(torch.from_numpy(g), torch.from_numpy(err))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                  (g + err) - np.asarray(je))


_WORLD = """
import numpy as np
import torch

from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.train.grad_compress import (compressed_all_reduce_mean,
                                             make_compressed_allreduce)


def draw(seed, shape=(37, 19), scale=3.0):
    rng = np.random.default_rng(seed)
    g = (scale * rng.standard_normal(shape)).astype(np.float32)
    err = (0.01 * rng.standard_normal(shape)).astype(np.float32)
    return g, err


def work(rank, n, out):
    g, err = draw(rank)
    mean, new = compressed_all_reduce_mean(torch.from_numpy(g),
                                           torch.from_numpy(err))
    mesh = make_debug_mesh()
    by_axis = {}
    for axes in (("data",), ("model",), ("data", "model")):
        f = make_compressed_allreduce(mesh, axes)
        m, e = f({"w": torch.from_numpy(g)}, {"w": torch.from_numpy(err)})
        by_axis["_".join(axes)] = m["w"].numpy()
    np.savez(f"{out}/rank{rank}.npz", mean=mean.numpy(), err=new.numpy(),
             coord=np.asarray(mesh.get_coordinate()), **by_axis)
"""


def test_four_rank_gloo_all_reduce_matches_jax(tmp_path):
    gloo_world(4, _WORLD, tmp_path)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(4)]
    deq, errs = [], []
    for r in range(4):
        g, err = _draw(r)
        q, s, e = jax_compress(jnp.asarray(g), jnp.asarray(err))
        deq.append(np.asarray(q, np.float32) * np.float32(s))
        errs.append(np.asarray(e))
    want = np.mean(deq, axis=0)
    # the ranks' f32 sum runs in gloo's order: rtol 1e-6 of the summands'
    # scale, where an element near 0 cancels
    atol = 1e-6 * np.abs(deq).max()
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["mean"], want, rtol=1e-6, atol=atol)
        np.testing.assert_array_equal(got["err"], errs[r])
        np.testing.assert_allclose(got["data_model"], want, rtol=1e-6,
                                   atol=atol)
        # (2, 2) mesh: ranks sharing a model coordinate average over data
        for axis, dim in (("data", 1), ("model", 0)):
            peers = [p for p in range(4) if ranks[p]["coord"][dim]
                     == got["coord"][dim]]
            np.testing.assert_allclose(
                got[axis], np.mean([deq[p] for p in peers], axis=0),
                rtol=1e-6, atol=atol)
