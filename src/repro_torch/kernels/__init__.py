"""The port's kernels: CUDA C++ sources under ``csrc/``, built by
``_build`` at first use, each beside its plain PyTorch version."""
from __future__ import annotations

import contextlib
import contextvars

import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raise if autograd would record a raw kernel call: its output is
    written by the kernel, so it would carry no gradient. Differentiable
    callers go through the ``autograd.Function`` in the kernel's
    ``ops``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad; the raw kernel has no "
            f"backward (call it through ops, whose autograd.Function "
            f"differentiates the plain version)")


def plain_backward(plain, ctx, grad_outs, n_opts: int):
    """The backward of a kernel's ``autograd.Function``: recompute the
    plain version ``plain(*saved inputs)`` (a tuple of outputs) under
    grad mode and return its gradients for the inputs that need one,
    None for the rest and for the ``n_opts`` trailing non-tensor
    arguments. An output whose incoming gradient is None (the caller did
    not use it) adds nothing."""
    inputs = [None if t is None else t.detach().requires_grad_(need)
              for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    wanted = [t for t in inputs if t is not None and t.requires_grad]
    used = [i for i, g in enumerate(grad_outs) if g is not None]
    if not wanted or not used:
        return (None,) * (len(inputs) + n_opts)
    with torch.enable_grad():
        outs = plain(*inputs)
        grads = iter(torch.autograd.grad(
            [outs[i] for i in used], wanted, [grad_outs[i] for i in used],
            allow_unused=True))
    return (*(next(grads) if t is not None and t.requires_grad else None
              for t in inputs), *(None,) * n_opts)


def remat(fn, *args):
    """``fn(*args)``, rematerialised under autograd: when grad mode is on
    and a tensor argument requires grad, through
    ``torch.utils.checkpoint`` (non-reentrant), so its backward
    recomputes ``fn``'s intermediates instead of keeping them (the JAX
    package's ``jax.checkpoint`` around each chunk of its plain
    versions); otherwise a plain call."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        from torch.utils.checkpoint import checkpoint
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


_SCOPE: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "kernel_scope", default=None)


@contextlib.contextmanager
def kernel_scope(name: str):
    """Marks the ops of one kernel's route (its launch, or its plain
    version on the CPU), so that a dispatch-level counter
    (``launch.dryrun``) can tell them from the model's own ops."""
    token = _SCOPE.set(name)
    try:
        yield
    finally:
        _SCOPE.reset(token)


def current_kernel_scope() -> str | None:
    return _SCOPE.get()
