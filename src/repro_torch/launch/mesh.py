"""Meshes over the ranks of ``torch.distributed`` (the port of the JAX
package's ``launch/mesh.py``).

Production: (data=16, model=16), 256 ranks, or (pod=2, data=16,
model=16), 512 ranks; the ``pod`` axis is pure data parallelism. They run
over the world that is initialised: a real cluster's, or for the dry run
the fake one of ``launch.dryrun.ensure_fake_world``.

Functions, not module constants: importing this module touches no
process group.
"""
from __future__ import annotations

import torch

_DEVICE_TYPE = {"gloo": "cpu", "fake": "cpu", "nccl": "cuda"}


def _world():
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("no process group: start the ranks with "
                           "torchrun, or the dry run's fake world")
    return dist


def mesh_device_type() -> str:
    """``cuda`` on NCCL, ``cpu`` on gloo and on the fake world."""
    return _DEVICE_TYPE[str(_world().get_backend())]


def make_production_mesh(*, multi_pod: bool = False):
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = _world().get_world_size()
    if n != int(torch.tensor(shape).prod()):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{int(torch.tensor(shape).prod())} ranks, the "
                         f"world has {n}")
    return init_device_mesh(mesh_device_type(), shape, mesh_dim_names=axes)


def debug_mesh_shape(n: int, *, pod: bool = False):
    """JAX's shape rule: ``pod=True`` with n a multiple of 4 (and ≥ 8)
    gives (2, 2, n//4) over ("pod", "data", "model"); even n puts the
    factor of 2 on ``data``; odd n is (1, n). → (shape, axis names)."""
    if pod and n >= 8 and n % 4 == 0:
        return (2, 2, n // 4), ("pod", "data", "model")
    d = 2 if n % 2 == 0 and n >= 2 else 1
    return (d, n // d), ("data", "model")


def make_debug_mesh(n_devices: int | None = None, *, pod: bool = False):
    """A small mesh over the first ``n_devices`` ranks (default: all),
    with ``debug_mesh_shape``'s shape: one rank on one card gives (1, 1)."""
    from torch.distributed.device_mesh import DeviceMesh

    world = _world().get_world_size()
    n = n_devices or world
    if n > world:
        raise ValueError(f"make_debug_mesh: {n} devices requested but "
                         f"only {world} exist")
    shape, names = debug_mesh_shape(n, pod=pod)
    return DeviceMesh(mesh_device_type(), torch.arange(n).reshape(shape),
                      mesh_dim_names=names)
