"""Training substrate: AdamW, the cosine schedule, and the train step
with microbatch accumulation (the JAX package's ``train/``; its gradient
compression, a collective across hosts, has no one-card caller)."""
from .optimizer import adamw, cosine_schedule  # noqa: F401
from .train_step import TrainState, make_train_step  # noqa: F401
