"""Architecture configs of the port. ``get_config(name)`` returns the
published config; ``get_config(name, reduced=True)`` the small smoke
variant (same structure, tiny dims). All ten architectures of the JAX
package are ported; ``runnable_cells`` lists the (arch, shape) pairs the
JAX package's dry run honours."""
from __future__ import annotations

import importlib

ARCHS = (
    "gemma2-2b",
    "smollm-360m",
    "minicpm3-4b",
    "internlm2-20b",
    "zamba2-2.7b",
    "mixtral-8x22b",
    "deepseek-v2-236b",
    "pixtral-12b",
    "rwkv6-3b",
    "hubert-xlarge",
)

PORTED = ARCHS


def get_config(name: str, reduced: bool = False):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {', '.join(ARCHS)}")
    mod = importlib.import_module(
        f"{__name__}.{name.replace('-', '_').replace('.', 'p')}")
    return mod.reduced_config() if reduced else mod.config()


SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

SHAPE_DEFS = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


def runnable_cells():
    """All (arch, shape) pairs honoring the documented skips
    (DESIGN.md §4): long_500k only for sub-quadratic archs; no decode
    shapes for encoder-only archs."""
    cells = []
    for a in ARCHS:
        cfg = get_config(a)
        for s in SHAPES:
            kind = SHAPE_DEFS[s]["kind"]
            if cfg.is_encoder and kind == "decode":
                continue
            if s == "long_500k" and not cfg.sub_quadratic:
                continue
            cells.append((a, s))
    return cells
