"""Per-architecture training policies shared by dryrun/roofline/perf
(a copy of the JAX package's ``launch/policies.py``; no side effects)."""

# Microbatch accumulation per train cell (activation-memory fit on 16 GiB
# v5e HBM; the accumulation scan also gives XLA per-microbatch grad
# collectives to overlap — the Sec-5.4 pipelining analogue).
TRAIN_ACCUM = {
    "minicpm3-4b": 4,
    "internlm2-20b": 2,
    "mixtral-8x22b": 4,
    "deepseek-v2-236b": 8,
    "hubert-xlarge": 2,
}

# ≥100B models: bf16 first moment + bf16 grad accumulation (HBM fit);
# the 236B model additionally keeps the second moment in bf16 (2.36 TB of
# model state on a 4 TB pod — DESIGN.md §7 records the trade-off).
TRAIN_LOWMEM = {"deepseek-v2-236b", "mixtral-8x22b"}
TRAIN_V_BF16 = {"deepseek-v2-236b"}
