"""Atomic checkpointing (the port of the JAX package's
``checkpoint/checkpointer.py``, with its on-disk layout).

Layout per step: ``<dir>/step_<n>.tmp…/`` → rename to ``<dir>/step_<n>/``
(atomic publish; a crash mid-write never corrupts the latest checkpoint).
Arrays are copied to the host and saved as one ``arrays.npz`` (keys are
the tree paths with "/" written "|") plus a json manifest (shapes, dtypes,
step). numpy has no bfloat16: a bf16 tensor is saved as its 16-bit
pattern and the manifest's dtype "bfloat16" turns it back on restore.

``restore(device=...)`` puts each leaf on the given device;
``restore(placements=..., mesh=...)`` also distributes each leaf over a
device mesh (JAX's ``shardings``, the elastic path: a checkpoint holds
whole tensors, so it restores onto any mesh). A DTensor leaf is saved
whole (``full_tensor``, a collective every rank of its mesh joins).
Background saving copies to the host in the caller and writes on a
thread, so the train loop runs on; ``wait()`` joins it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    tree: dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _to_host(v) -> tuple[np.ndarray, str]:
    """(numpy array, the manifest's dtype name)."""
    if isinstance(v, torch.Tensor):
        if hasattr(v, "full_tensor"):           # a DTensor: saved whole
            v = v.full_tensor()
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(v)
    return a, str(a.dtype)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- save
    def save(self, state, step: int, *, background: bool = False):
        self.wait()   # never two writers in flight (incl. fg after bg)
        host = {k: _to_host(v) for k, v in _flatten(state).items()}
        if background:
            self._thread = threading.Thread(
                target=self._write, args=(host, step), daemon=True)
            self._thread.start()
        else:
            self._write(host, step)

    def _write(self, host: dict, step: int):
        tmp = os.path.join(self.dir,
                           f"step_{step}.tmp{os.getpid()}.{id(host)}")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(final):   # published already: JAX's writes the
            self._gc()              # copy and then drops it
            return
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k.replace("/", "|"): a for k, (a, _) in host.items()})
        manifest = {
            "step": step,
            "keys": {k: {"shape": list(a.shape), "dtype": dt}
                     for k, (a, dt) in host.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):   # another writer published meanwhile
            shutil.rmtree(tmp, ignore_errors=True)
        else:
            os.replace(tmp, final)
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and ".tmp" not in d:
                try:
                    out.append(int(d.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int | None = None, device=None,
                placements=None, mesh=None):
        """(state tree of tensors, step): the latest checkpoint unless
        ``step`` is given, each leaf on ``device`` (the CPU when None).
        With ``placements`` (a tree of DTensor placements, any part of the
        state's) and ``mesh``, each leaf it names becomes a DTensor on
        ``mesh`` holding this rank's shard (no communication: every rank
        reads the whole leaf)."""
        step = step if step is not None else self.latest()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            keys = json.load(f)["keys"]
        flat = {}
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for name in data.files:
                key = name.replace("|", "/")
                t = torch.from_numpy(data[name])
                if keys[key]["dtype"] == "bfloat16":
                    t = t.view(torch.bfloat16)
                flat[key] = t if device is None else t.to(device)
        if placements is not None:
            from torch.distributed.tensor import distribute_tensor
            where = _flatten(placements)
            flat = {k: distribute_tensor(t, mesh, where[k],
                                         src_data_rank=None)
                    if k in where else t for k, t in flat.items()}
        return _unflatten(flat), step
