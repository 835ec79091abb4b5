"""What ``chip_smoke.py`` does not cover of the port's CUDA kernels: the
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

F32_TOL = dict(rtol=3e-5, atol=1.2e-4)


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
