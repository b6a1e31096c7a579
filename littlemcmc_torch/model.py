"""Model adapters: turn user callables into ``q -> (logp, grad)`` functions.

Counterpart of ``littlemcmc_tpu/model.py:33-109``. A model is either a
``logp_dlogp_func`` that already returns the pair or a scalar ``logp_fn``,
differentiated with ``torch.func.grad_and_value``. Both take one chain's
``(n,)`` position; :func:`batched` lifts one to ``(C, n)`` with
``torch.func.vmap``. :func:`from_numpy_callable` wraps the reference's own
numpy ``logp_dlogp_func`` unchanged.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

__all__ = ["as_logp_grad", "from_logp_fn", "from_numpy_callable", "batched"]

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


class _NumpyModel:
    """A host numpy ``(logp, grad)`` function as a model: ``logp_grad`` for
    one chain or a batch, ``batched_logp_grad`` the same function, which
    :func:`batched` finds on the bound method."""

    def __init__(self, func, dtype):
        self.func, self.dtype = func, dtype

    def logp_grad(self, q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = q.detach().cpu().numpy().astype(np.float64)
        logps = np.empty(x.shape[:-1])
        grads = np.empty(x.shape)
        for idx in np.ndindex(*x.shape[:-1]):
            logps[idx], grads[idx] = self.func(x[idx])
        return (torch.from_numpy(logps).to(q.device, self.dtype),
                torch.from_numpy(grads).to(q.device, self.dtype))

    batched_logp_grad = logp_grad


def from_numpy_callable(func: Callable[[np.ndarray], Tuple[float, np.ndarray]],
                        model_ndim: int, dtype=torch.float32) -> LogpGradFn:
    """Wrap a host (numpy) ``logp_dlogp_func`` for the port, unchanged
    (reference ``littlemcmc_tpu/model.py:74-109``): ``func`` takes one
    chain's float64 ``(model_ndim,)`` position and returns ``(logp,
    grad)``. Every evaluation copies the positions to the host, loops over
    the chains there and copies the results back: orders of magnitude
    slower than a model written in PyTorch, but it lets reference users
    run their models as they are. ``sample`` runs it on the per-draw
    engine's tensor ops (the NUTS tree)."""
    del model_ndim  # accepted for signature parity
    return _NumpyModel(func, dtype).logp_grad
