"""The port's GEMM plain version and calibration pass against the JAX
package's: ``matmul_ref`` against the JAX ``matmul_ref`` and the Pallas
kernel in interpret mode at the JAX suite's shapes and limits; the smoke
profile's samples against the JAX pass's; the fit, ``apply`` and the
profile store. Inputs are made with numpy and handed to both."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hw import HWConfig as JaxHW
from repro.core.hw import MCMType as JaxMCM
from repro.kernels import calibrate as j_cal
from repro.kernels.gemm.kernel import matmul as pallas_matmul
from repro.kernels.gemm.ref import matmul_ref as jax_matmul_ref
from repro_torch.core.hw import HWConfig, MCMType
from repro_torch.kernels import calibrate as t_cal
from repro_torch.kernels.gemm import ops
from repro_torch.kernels.gemm.kernel import matmul as gemm_kernel
from repro_torch.kernels.gemm.ref import matmul_ref
from repro_torch.serve.cache_store import CacheStore

# tests/test_kernels.py's GEMM shapes and limits (rtol, atol = 8·rtol).
GEMM_SHAPES = [(128, 128, 128), (256, 512, 128), (100, 70, 130),
               (33, 257, 65)]
GEMM_TOL = {"float32": (2e-5, 1.6e-4), "bfloat16": (3e-2, 0.24)}


def _operands(m, k, n, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    to_t = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    to_j = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return ((torch.from_numpy(a).to(to_t), torch.from_numpy(b).to(to_t)),
            (jnp.asarray(a, to_j), jnp.asarray(b, to_j)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
def test_matmul_ref_matches_jax_and_pallas(m, k, n, dtype):
    (ta, tb), (ja, jb) = _operands(m, k, n, dtype, seed=m + k + n)
    got = matmul_ref(ta, tb)
    assert got.dtype == ta.dtype and tuple(got.shape) == (m, n)
    got = got.float().numpy()
    rtol, atol = GEMM_TOL[dtype]
    for want in (jax_matmul_ref(ja, jb),
                 pallas_matmul(ja, jb, bm=64, bn=64, bk=64, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=rtol, atol=atol)


def test_matmul_op_sends_cpu_tensors_to_the_plain_version():
    (a, b), _ = _operands(33, 65, 17, "bfloat16", seed=0)
    before = gemm_kernel.launches
    torch.testing.assert_close(ops.matmul(a, b), matmul_ref(a, b),
                               rtol=0, atol=0)
    assert gemm_kernel.launches == before


def test_gemm_kernel_rejects_cpu_tensors():
    """The kernel never takes CPU tensors; the check comes before any
    build or launch."""
    a = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        gemm_kernel(a, a.T.contiguous())


# ------------------------------------------------------------ calibration
@pytest.fixture(scope="module")
def smoke_profiles():
    return (t_cal.profile_kernels(smoke=True, reps=1, device="cpu"),
            j_cal.profile_kernels(smoke=True, reps=1))


def test_smoke_profile_samples_match_jax(smoke_profiles):
    got, want = smoke_profiles
    assert got.backend == "cpu"
    assert [(s.kernel, s.shape, s.ideal_bytes) for s in got.samples] == \
        [(s.kernel, s.shape, s.ideal_bytes) for s in want.samples]
    for g, w in zip(got.samples, want.samples):
        assert g.flops > 0 and g.wall_s > 0 and g.reps == 1
        assert g.achieved_bytes_per_s == g.ideal_bytes / g.wall_s
        if g.kernel == "gemm":        # XLA's cost_analysis of matmul_ref
            assert g.flops == w.flops
    assert got.byte_overhead == 1.0
    assert got.flops_per_s == max(s.achieved_flops_per_s
                                  for s in got.samples if s.kernel == "gemm")
    assert got.nop_frac == pytest.approx(450 / 3350)


@pytest.mark.parametrize("seed", [0, 7])
def test_smoke_inputs_match_jax_at_seed(monkeypatch, seed):
    """Both passes draw the same f32 inputs from ``seed``, in the same
    order (each bench's ``_measure`` replaced by a recorder)."""
    drawn = {"jax": [], "torch": []}

    def record_jax(fn, args, *, reps):
        drawn["jax"].append([np.asarray(a) for a in args])
        return 1.0, 1.0, 1e-6

    def record_torch(fn, args, *, reps, device):
        drawn["torch"].append([a.numpy() for a in args
                               if isinstance(a, torch.Tensor)])
        return 1e-6

    monkeypatch.setattr(j_cal, "_measure", record_jax)
    monkeypatch.setattr(t_cal, "_measure", record_torch)
    j_cal.profile_kernels(smoke=True, reps=1, seed=seed)
    t_cal.profile_kernels(smoke=True, reps=1, seed=seed, device="cpu")
    assert len(drawn["torch"]) == len(drawn["jax"]) == 5
    for got, want in zip(drawn["torch"], drawn["jax"]):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    first = drawn["torch"][0][0]
    t_cal.profile_kernels(smoke=True, reps=1, seed=seed + 1, device="cpu")
    assert not np.array_equal(drawn["torch"][-5][0], first)


def _fixed_samples():
    """(kernel, shape, flops, ideal_bytes, wall_s)."""
    return [("gemm", (8, 8, 8), 1024.0, 768.0, 2e-6),
            ("gemm", (16, 16, 16), 8192.0, 3072.0, 5e-6),
            ("flash_attention", (1, 8, 1, 4), 512.0, 512.0, 1e-6),
            ("rwkv6", (1, 8, 1, 4, 4), 256.0, 400.0, 3e-6),
            ("ssm_scan", (1, 8, 1, 4, 1, 4, 4), 300.0, 350.0, 4e-6)]


def test_fit_matches_jax(monkeypatch):
    """The JAX pass's fit (its bench functions replaced by fixed samples
    whose HLO bytes are their ideal bytes, as a kernel moves) and the
    port's ``fit_profile`` on the same samples."""
    j_samples = [j_cal.KernelSample(k, shp, f, ideal, ideal, w)
                 for k, shp, f, ideal, w in _fixed_samples()]
    for name in ("_bench_gemm", "_bench_attention", "_bench_rwkv6",
                 "_bench_ssm_scan"):
        kernel = {"_bench_gemm": "gemm", "_bench_attention":
                  "flash_attention", "_bench_rwkv6": "rwkv6",
                  "_bench_ssm_scan": "ssm_scan"}[name]
        monkeypatch.setattr(j_cal, name, lambda rng, sizes, reps, k=kernel: [
            s for s in j_samples if s.kernel == k])
    want = j_cal.profile_kernels(smoke=True)
    got = t_cal.fit_profile([t_cal.KernelSample(*s)
                             for s in _fixed_samples()], want.backend)
    for f in ("backend", "flops_per_s", "bytes_per_s", "byte_overhead",
              "bw_mem_model"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.byte_overhead == 1.0
    assert got.freq_for(128, 128) == want.freq_for(128, 128)


@pytest.mark.parametrize("mcm", ["A", "C", "D"])
def test_apply_matches_jax(mcm):
    kw = dict(backend="cuda", flops_per_s=2.5e13, bytes_per_s=1.9e12,
              byte_overhead=1.5, nop_frac=t_cal.NVLINK_OVER_HBM)
    want = j_cal.CalibratedHW(**kw).apply(
        JaxHW(X=2, Y=3, R=64, C=32, mcm_type=JaxMCM(mcm)))
    got = t_cal.CalibratedHW(**kw).apply(
        HWConfig(X=2, Y=3, R=64, C=32, mcm_type=MCMType(mcm)))
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        assert getattr(g, "value", g) == getattr(w, "value", w), f.name


def test_profile_store_roundtrip(tmp_path):
    prof = t_cal.CalibratedHW(
        backend="cuda", flops_per_s=1e13, bytes_per_s=1e12, byte_overhead=1.0,
        samples=(t_cal.KernelSample("gemm", (8, 8, 8), 1024.0, 768.0, 1e-6,
                                    3),))
    path = str(tmp_path / "prof.bin")
    t_cal.save_profile(prof, path)
    assert t_cal.load_profile(path) == prof


def test_profile_load_degrades_to_none(tmp_path):
    assert t_cal.load_profile(str(tmp_path / "missing.bin")) is None
    corrupt = tmp_path / "corrupt.bin"
    corrupt.write_bytes(b"not a record store")
    assert t_cal.load_profile(str(corrupt)) is None
    stale = t_cal.CalibratedHW(backend="cuda", flops_per_s=1.0,
                               bytes_per_s=1.0, byte_overhead=1.0, schema=-1)
    path = str(tmp_path / "stale.bin")
    CacheStore(path).save({("calibrated_hw", -1): stale})
    assert t_cal.load_profile(path) is None
    # a torn tail drops only the torn record: the header alone is a miss
    good = str(tmp_path / "torn.bin")
    t_cal.save_profile(stale.__class__(backend="cuda", flops_per_s=1.0,
                                       bytes_per_s=1.0, byte_overhead=1.0),
                       good)
    blob = open(good, "rb").read()
    open(good, "wb").write(blob[:-3])
    assert t_cal.load_profile(good) is None


def test_profile_kernels_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cal.profile_kernels(smoke=True, reps=1)
