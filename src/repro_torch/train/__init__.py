"""Training substrate: AdamW, the cosine schedule, the train step with
microbatch accumulation, and the int8 error-feedback all-reduce
(``grad_compress``): the JAX package's ``train/``."""
from .optimizer import adamw, cosine_schedule  # noqa: F401
from .train_step import TrainState, make_train_step  # noqa: F401
