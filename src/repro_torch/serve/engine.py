"""Batched serving engine: prefill + decode over a fixed request batch
with greedy or temperature sampling. Prompt lists longer than the batch
run in waves. Runs eagerly; on the card, prefill goes through the CUDA
kernels (flash attention for the dense and moe families, MLA's latent
head among them, and zamba2's shared attention, WKV-6 for RWKV-6, the
SSD scan for zamba2's Mamba-2 layers).
The RWKV-6 and Mamba-2 states have a constant size, so ``capacity``
matters to the attention caches only.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device
from ..models import forward, init_caches


class ServeEngine:
    def __init__(self, cfg, model, batch_size: int = 4,
                 capacity: int = 256, temperature: float = 0.0,
                 seed: int = 0, device=None):
        if cfg.is_encoder:
            raise ValueError("encoder-only models have no decode path")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model.to(self.device)
        self.B = batch_size
        self.capacity = capacity
        self.temperature = temperature
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        # Host seconds per prefill (one per wave) and per decode step,
        # each ending where the sampled tokens reach the host.
        self.timings = {"prefill_s": [], "decode_s": []}

    def _sample(self, logits):
        lg = logits[:, -1, : self.cfg.vocab_size]
        if self.temperature <= 0:
            return torch.argmax(lg, dim=-1)   # ties: first index
        probs = torch.softmax(lg.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.gen)[:, 0]

    @staticmethod
    def pad_wave(prompts) -> np.ndarray:
        """Left-pad prompts with token 0 to a common length (aligned
        positions). Prefill applies no padding mask, as in the JAX
        engine: real tokens attend to the pad tokens."""
        L = max(len(p) for p in prompts)
        toks = np.zeros((len(prompts), L), np.int64)
        for i, p in enumerate(prompts):
            toks[i, L - len(p):] = p
        return toks

    def generate(self, prompts: list[np.ndarray],
                 max_new_tokens: int = 16) -> list[list[int]]:
        """Static-batch generation: pad prompts to a common length, prefill
        once, decode. Prompt lists larger than the batch run in waves."""
        outs: list[list[int]] = []
        for i in range(0, len(prompts), self.B):
            outs.extend(self._generate_wave(prompts[i: i + self.B],
                                            max_new_tokens))
        return outs

    @torch.inference_mode()
    def _generate_wave(self, prompts, max_new_tokens):
        toks = torch.from_numpy(self.pad_wave(prompts)).to(self.device)
        B, L = toks.shape
        caches = init_caches(self.cfg, B, self.capacity, device=self.device)
        t0 = time.perf_counter()
        logits, caches = forward(self.model, {"tokens": toks},
                                 mode="prefill", caches=caches)
        nxt = self._sample(logits)
        outs = [[t] for t in nxt.tolist()]
        self.timings["prefill_s"].append(time.perf_counter() - t0)
        pos = L
        for _ in range(max_new_tokens - 1):
            t0 = time.perf_counter()
            logits, caches = forward(self.model, {"tokens": nxt[:, None]},
                                     mode="decode", caches=caches, pos=pos)
            nxt = self._sample(logits)
            for o, t in zip(outs, nxt.tolist()):
                o.append(t)
            self.timings["decode_s"].append(time.perf_counter() - t0)
            pos += 1
        return outs
