"""Port ServeEngine on the CPU against the JAX ServeEngine on the same
converted weights, plus the engine's own invariants."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_model as jax_init_model
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.models import Transformer, init_caches, init_model
from repro_torch.models.convert import from_jax_params
from repro_torch.serve import ServeEngine

LENGTHS = (5, 9, 3, 7, 4)


@pytest.fixture(scope="module")
def f32():
    jcfg = jax_get_config("smollm-360m", reduced=True).replace(
        dtype="float32")
    params = jax.jit(jax_init_model, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    cfg = get_config("smollm-360m", reduced=True).replace(dtype="float32")
    model = Transformer(cfg, "cpu")
    model.load_state_dict(from_jax_params(
        cfg, jax.tree.map(np.asarray, params)))
    return (jcfg, params), (cfg, model)


def _prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lengths]


def test_greedy_tokens_match_jax_engine(f32):
    """f32 weights, the engines' default bf16 cache, waves of 2 with
    left-padding: identical greedy tokens."""
    (jcfg, params), (cfg, model) = f32
    prompts = _prompts(cfg, LENGTHS)
    want = JaxServeEngine(jcfg, params, batch_size=2,
                          capacity=64).generate(prompts, 6)
    got = ServeEngine(cfg, model, batch_size=2, capacity=64,
                      device="cpu").generate(prompts, 6)
    assert got == want


def test_wave_split_matches_single_wave(f32):
    cfg, model = f32[1]
    eng = ServeEngine(cfg, model, batch_size=2, capacity=64, device="cpu")
    prompts = _prompts(cfg, LENGTHS)
    full = eng.generate(prompts, max_new_tokens=6)
    assert len(full) == 5
    by_wave = []
    for i in range(0, len(prompts), 2):
        by_wave.extend(eng.generate(prompts[i: i + 2], max_new_tokens=6))
    assert full == by_wave
    assert len(eng.timings["prefill_s"]) == 6       # one per wave


def test_temperature_sampling_seed_reproducible(f32):
    cfg, model = f32[1]
    prompts = _prompts(cfg, (5, 3))

    def gen(seed):
        return ServeEngine(cfg, model, batch_size=2, capacity=64,
                           temperature=0.8, seed=seed,
                           device="cpu").generate(prompts, 8)
    assert gen(3) == gen(3)
    assert gen(3) != gen(4)


def test_entry_points_default_to_cuda(f32, monkeypatch):
    """device=None means the card; without one they raise instead of
    running on the CPU."""
    cfg, model = f32[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, model)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_caches(cfg, 1, 8)
