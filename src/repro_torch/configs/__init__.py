"""Architecture configs of the port. ``get_config(name)`` returns the
published config; ``get_config(name, reduced=True)`` the small smoke
variant (same structure, tiny dims). Architectures the port does not
serve yet raise ``NotImplementedError`` naming the slice that brings
them (ROADMAP.md, queue A)."""
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

PORTED = ("smollm-360m", "rwkv6-3b", "zamba2-2.7b", "gemma2-2b",
          "internlm2-20b", "minicpm3-4b", "mixtral-8x22b")

_ZOO = ("slice 13 of the port (deepseek-v2: MLA with MoE; pixtral-12b: "
        "the vision frontend; hubert-xlarge: the audio encoder)")


def get_config(name: str, reduced: bool = False):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {', '.join(ARCHS)}")
    if name not in PORTED:
        raise NotImplementedError(
            f"{name} is not ported yet; it comes with "
            f"{_ZOO} (ROADMAP.md, queue A)")
    mod = importlib.import_module(
        f"{__name__}.{name.replace('-', '_').replace('.', 'p')}")
    return mod.reduced_config() if reduced else mod.config()
