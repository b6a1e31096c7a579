"""Model adapters: turn user callables into ``q -> (logp, grad)`` functions.

Counterpart of ``littlemcmc_tpu/model.py:33-72``. A model is either a
``logp_dlogp_func`` that already returns the pair or a scalar ``logp_fn``,
differentiated with ``torch.func.grad_and_value``. Both take one chain's
``(n,)`` position; :func:`batched` lifts one to ``(C, n)`` with
``torch.func.vmap``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

__all__ = ["as_logp_grad", "from_logp_fn", "batched"]

LogpGradFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def from_logp_fn(logp_fn: Callable[[torch.Tensor], torch.Tensor]) -> LogpGradFn:
    """Autodiff a scalar log-density into a ``(logp, grad)`` pair."""
    grad_and_value = torch.func.grad_and_value(logp_fn)

    def logp_grad(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        grad, logp = grad_and_value(q)
        return logp, grad

    return logp_grad


def as_logp_grad(logp_dlogp_func: Optional[LogpGradFn] = None,
                 logp_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                 ) -> LogpGradFn:
    """Normalize the user's model into a per-chain ``q -> (logp, grad)``."""
    if (logp_dlogp_func is None) == (logp_fn is None):
        raise ValueError("Provide exactly one of `logp_dlogp_func` or `logp_fn`.")
    if logp_fn is not None:
        return from_logp_fn(logp_fn)
    return logp_dlogp_func


def batched(logp_grad: LogpGradFn) -> LogpGradFn:
    """``(C, n) -> ((C,), (C, n))``: the model's own batched form when the
    function is a bound method of a model that has one, else a vmap."""
    owner = getattr(logp_grad, "__self__", None)
    native = getattr(owner, "batched_logp_grad", None)
    return native if native is not None else torch.func.vmap(logp_grad)
