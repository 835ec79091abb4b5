"""The port's model zoo: the dense family (GQA, MLA, gemma2's local/global
pairs), the moe family, the RWKV-6 ssm and the zamba2 hybrid families.

>>> cfg = get_config("smollm-360m", reduced=True)
>>> model = init_model(cfg, seed=0, device="cpu")
>>> logits, caches = forward(model, {"tokens": tok})
"""
from .config import ModelConfig  # noqa: F401
from .transformer import (Transformer, forward, init_caches,  # noqa: F401
                          init_model)
