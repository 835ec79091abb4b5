"""Deterministic synthetic data pipeline with host sharding (the port's
copy of the JAX package's ``data/pipeline.py``: the same numpy arrays,
bit for bit, for every (seed, step, host)).

Every batch is a pure function of (seed, step, host), so any host can
crash and resume at an arbitrary step with bitwise-identical data — the
property the fault-tolerance layer (checkpoint/restart, stragglers
rescheduled onto fresh hosts) relies on. A real deployment swaps
``synthetic_*`` for tokenized shards; the interface (``__iter__`` over
step-indexed batches + ``at(step)`` random access) is the contract.
Batches stay numpy here: the train step puts them on its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    kind: str                 # "lm" | "vlm" | "audio"
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_dim: int = 0
    frontend_tokens: int = 0
    n_hosts: int = 1
    host_id: int = 0


def _rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id]))


class Pipeline:
    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_hosts

    def at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = _rng(cfg, step)
        B, S = self.local_batch, cfg.seq_len
        if cfg.kind == "lm":
            # Markov-ish synthetic text: learnable bigram structure so the
            # example driver's loss actually decreases.
            base = rng.integers(0, cfg.vocab_size, (B, 1))
            steps = rng.integers(0, 17, (B, S - 1)).cumsum(axis=1)
            toks = np.concatenate([base, (base + steps) % cfg.vocab_size],
                                  axis=1)
            return {"tokens": toks.astype(np.int32)}
        if cfg.kind == "vlm":
            st = S - cfg.frontend_tokens
            toks = rng.integers(0, cfg.vocab_size, (B, st), dtype=np.int32)
            patches = rng.standard_normal(
                (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(
                    np.float32)
            return {"tokens": toks, "patches": patches}
        if cfg.kind == "audio":
            frames = rng.standard_normal((B, S, cfg.frontend_dim)).astype(
                np.float32)
            mask = rng.random((B, S)) < 0.08
            # span masking: dilate
            for _ in range(4):
                mask[:, 1:] |= mask[:, :-1]
            labels = rng.integers(0, cfg.vocab_size, (B, S),
                                  dtype=np.int32)
            return {"frames": frames, "mask": mask, "labels": labels}
        raise ValueError(cfg.kind)

    def __iter__(self):
        step = 0
        while True:
            yield self.at(step)
            step += 1


def make_pipeline(cfg, shape_def, seed=0, n_hosts=1, host_id=0) -> Pipeline:
    """Build the pipeline matching a model config + shape cell."""
    kind = {"vlm": "vlm", "audio": "audio"}.get(cfg.family, "lm")
    if cfg.frontend == "vision_stub":
        kind = "vlm"
    return Pipeline(DataConfig(
        kind=kind, vocab_size=cfg.vocab_size,
        seq_len=shape_def["seq_len"], global_batch=shape_def["global_batch"],
        seed=seed, frontend_dim=cfg.frontend_dim,
        frontend_tokens=cfg.frontend_tokens, n_hosts=n_hosts,
        host_id=host_id))
