"""What ``chip_smoke.py`` does not cover of the port's CUDA kernels: each
kernel on strided views, its rejects, one launch per call, and the
build. (The kernel against its plain version at every variant, in both
dtypes, is ``chip_smoke.py``'s kernel phase.) The ``cuda``-marked tests
need an NVIDIA Hopper card and nvcc and skip elsewhere. Imports no JAX,
so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.blockwise import blockwise_attention
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.rwkv6.chunked import wkv6_chunked
from repro_torch.kernels.rwkv6.kernel import wkv6

F32_TOL = dict(rtol=3e-5, atol=1.2e-4)
WKV_F32_TOL = dict(rtol=2e-3, atol=2e-3)   # the JAX suite's WKV limit


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_flash_kernel_reads_strided_views(cuda):
    """q/k/v as views into one fused projection (non-contiguous heads);
    one launch per call."""
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(2, 70, 4 + 2 + 2, 32, generator=g, device=cuda)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True)
    assert flash_attention.launches == before + 1
    want = blockwise_attention(q, k, v, causal=True)
    torch.testing.assert_close(got, want, **F32_TOL)


@pytest.mark.cuda
def test_flash_kernel_rejects_bad_inputs(cuda):
    q = torch.zeros(1, 8, 4, 32, device=cuda)
    k = torch.zeros(1, 8, 3, 32, device=cuda)
    with pytest.raises(ValueError, match="H % KV"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="contiguous"):
        qt = q.transpose(-1, -2)
        flash_attention(qt, qt, qt)


@pytest.mark.cuda
def test_wkv6_kernel_reads_strided_views(cuda):
    """r/k/v/w as head views of one fused (B, S, 4·H·K) projection, from
    a nonzero state; y and the final state; one launch per call."""
    B, S, H, K = 2, 70, 3, 64
    g = torch.Generator(device=cuda).manual_seed(2)
    proj = torch.randn(B, S, 4 * H * K, generator=g, device=cuda)
    r, k, v, w = (t.unflatten(-1, (H, K)) for t in proj.chunk(4, dim=-1))
    w = torch.exp(-torch.exp(0.5 * w))
    u = 0.3 * torch.randn(H, K, generator=g, device=cuda)
    s0 = 0.3 * torch.randn(B, H, K, K, generator=g, device=cuda)
    assert not r.is_contiguous()
    before = wkv6.launches
    y, sT = wkv6(r, k, v, w, u, s0=s0)
    assert wkv6.launches == before + 1
    want_y, want_s = wkv6_chunked(r, k, v, w, u, s0=s0, chunk=32)
    torch.testing.assert_close(y, want_y, **WKV_F32_TOL)
    torch.testing.assert_close(sT, want_s, **WKV_F32_TOL)


@pytest.mark.cuda
def test_wkv6_kernel_rejects_bad_inputs(cuda):
    r = torch.zeros(1, 8, 2, 16, device=cuda)
    u = torch.zeros(2, 16, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        wkv6(r, r.bfloat16(), r, r, u)
    r24 = torch.zeros(1, 8, 2, 24, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        wkv6(r24, r24, r24, r24, torch.zeros(2, 24, device=cuda))
    with pytest.raises(ValueError, match="s0"):
        wkv6(r, r, r, r, u, s0=torch.zeros(1, 2, 16, 16, device=cuda,
                                           dtype=torch.bfloat16))
    odd = torch.zeros(1, 8, 2, 17, device=cuda)[..., 1:]
    with pytest.raises(ValueError, match="aligned"):
        wkv6(odd, r, r, r, u)


def test_wkv6_kernel_rejects_cpu_tensors():
    """The kernel never takes CPU tensors (``ops.wkv6`` sends those to
    the plain version); the check comes before any build or launch."""
    r = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        wkv6(r, r, r, r, torch.zeros(2, 16))


def test_build_without_nvcc_raises_clearly(tmp_path, monkeypatch):
    """No cached library and no nvcc: a RuntimeError that says so."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["flash_attention"])


def test_library_is_keyed_by_source():
    path = _build.library_path("flash_attention")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("flash_attention-") and path.suffix == ".so"
