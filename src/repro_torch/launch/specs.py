"""Abstract input/state specs for the dry run (the port of the JAX
package's ``launch/specs.py``): DTensors placed on the mesh whose local
shards are fake tensors, so no memory is ever allocated. Call them inside
the dry run's ``FakeTensorMode`` (``launch.dryrun.fake_mode``): they
allocate with ``torch.empty``, which the mode makes fake.

Each function returns (tree of DTensors, tree of Specs)."""
from __future__ import annotations

import torch

from ..configs import SHAPE_DEFS
from ..models.transformer import Transformer, init_caches
from ..sharding.logical import local_shape, placements, sanitize_spec
from ..sharding.partition_specs import (cache_shardings, data_specs,
                                        param_specs)


def abstract(shape, dtype, spec, mesh):
    """A DTensor of global ``shape`` with ``spec`` on ``mesh`` whose local
    shard is ``torch.empty`` on the mesh's device type (fake under
    ``FakeTensorMode``; on a real mesh the dry run fills it)."""
    from torch.distributed.tensor import DTensor

    local = torch.empty(local_shape(shape, spec, mesh), dtype=dtype,
                        device=mesh.device_type)
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _tree(shapes: dict, specs: dict, mesh):
    return {k: (_tree(v, specs[k], mesh) if isinstance(v, dict) else
                abstract(v.shape, v.dtype, specs[k], mesh))
            for k, v in shapes.items()}


def input_specs(cfg, shape_name: str, mesh) -> dict:
    """Every model input of one (arch × shape) cell: {tokens, ...} for
    train/prefill (with "patches" for the vision stub; "frames", and in
    training "mask" and "labels", for the audio stub); {tokens} (B, 1)
    for decode."""
    sd = SHAPE_DEFS[shape_name]
    S, B = sd["seq_len"], sd["global_batch"]
    kind = sd["kind"]
    ds = data_specs(mesh)

    def spec(shape, dtype, key):
        return abstract(shape, dtype, sanitize_spec(ds[key], shape, mesh),
                        mesh)

    batch = {}
    if cfg.frontend == "audio_stub":
        batch["frames"] = spec((B, S, cfg.frontend_dim), torch.bfloat16,
                               "frames")
        if kind == "train":
            batch["mask"] = spec((B, S), torch.bool, "mask")
            batch["labels"] = spec((B, S), torch.int64, "labels")
        return batch
    if kind == "decode":
        batch["tokens"] = spec((B, 1), torch.int64, "tokens")
        return batch
    st = S - (cfg.frontend_tokens if cfg.frontend == "vision_stub" else 0)
    batch["tokens"] = spec((B, st), torch.int64, "tokens")
    if cfg.frontend == "vision_stub":
        batch["patches"] = spec((B, cfg.frontend_tokens, cfg.frontend_dim),
                                torch.bfloat16, "patches")
    return batch


def _param_shapes(cfg) -> dict:
    """{name: meta tensor}: the training form, in ``param_dtype`` (JAX's
    parameters)."""
    return dict(Transformer(cfg, "meta", train=True).named_parameters())


def state_specs(cfg, mesh, m_dtype=torch.float32, v_dtype=torch.float32,
                fsdp_axes=("data",)):
    """The train state {"params", "opt": {"m", "v", "count"}, "step"}
    with params and Adam moments sharing the FSDP×TP layout (ZeRO by
    construction); the moments in ``m_dtype``/``v_dtype`` (the policies'
    bf16 for the largest models). ``fsdp_axes=("pod", "data")`` extends
    the sharding across pods."""
    shapes = _param_shapes(cfg)
    ps = param_specs(cfg, shapes, mesh, fsdp_axes)
    scalar = sanitize_spec((), (), mesh)

    def moments(dtype):
        return {n: abstract(p.shape, dtype, ps[n], mesh)
                for n, p in shapes.items()}
    state = {"params": {n: abstract(p.shape, p.dtype, ps[n], mesh)
                        for n, p in shapes.items()},
             "opt": {"m": moments(m_dtype), "v": moments(v_dtype),
                     "count": abstract((), torch.int32, scalar, mesh)},
             "step": abstract((), torch.int32, scalar, mesh)}
    specs = {"params": ps, "opt": {"m": ps, "v": ps, "count": scalar},
             "step": scalar}
    return state, specs


def params_specs_only(cfg, mesh, fsdp_axes=("data",)):
    shapes = _param_shapes(cfg)
    ps = param_specs(cfg, shapes, mesh, fsdp_axes)
    return {n: abstract(p.shape, p.dtype, ps[n], mesh)
            for n, p in shapes.items()}, ps


def cache_specs(cfg, shape_name: str, mesh):
    """The serving caches of a (B, S) cell in bf16, as JAX's."""
    sd = SHAPE_DEFS[shape_name]
    S, B = sd["seq_len"], sd["global_batch"]
    shapes = init_caches(cfg, B, S, dtype=torch.bfloat16, device="meta")
    sh = cache_shardings(shapes, cfg, mesh)
    return _tree(shapes, sh, mesh), sh
