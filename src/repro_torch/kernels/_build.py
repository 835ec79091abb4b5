"""Build the port's CUDA sources and load them with ctypes.

Each ``kernels/csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface,
``build/repro_torch/<name>-<hash>.so`` under the checkout, keyed by a
hash of the source, of every shared header (``csrc/*.cuh``) and of the
flags, so an edited source or header is rebuilt and an unchanged one is
not. A plain C interface keeps PyTorch's headers out of the build: seconds
per source instead of minutes.

The build runs at first use (``load``); ``build()`` runs it up front.
Both hold one process-wide lock, so threads that first touch a kernel
together (the optimisation server's worker beside the caller) build it
once and share one loaded library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")

_LOCK = threading.RLock()
_LOADED: dict[str, ctypes.CDLL] = {}


def sources() -> dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(DEFAULT_NVCC)
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, on PATH and in "
        "/usr/local/cuda/bin): the port's CUDA kernels are compiled from "
        "src/repro_torch/kernels/csrc at first use and need the CUDA "
        "toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256(sources()[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, Path]:
    """Compile every named source (default: all) whose library is
    missing, one ``nvcc`` per source, all started together. Returns the
    library path of each name; the compiler's output (register and
    shared-memory use per kernel) is kept beside it as ``.log``."""
    with _LOCK:
        return _build(names)


def _build(names) -> dict[str, Path]:
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    out = {n: library_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if todo:
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmps = {n: out[n].with_suffix(f".tmp{os.getpid()}.so") for n in todo}
    procs = {n: subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-o", str(tmps[n]), str(srcs[n])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n in todo}
    failed = []
    for n, proc in procs.items():
        log = proc.communicate()[0]
        out[n].with_suffix(".log").write_text(log)
        if proc.returncode:
            failed.append(f"nvcc failed for {n} (exit {proc.returncode}):"
                          f"\n{log}")
        else:
            os.replace(tmps[n], out[n])   # a library on disk is always whole
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed;
    one per process, whichever thread asks first."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = _LOADED[name] = ctypes.CDLL(str(build([name])[name]))
        return lib
