"""Bayesian logistic regression (BASELINE config 4).

Counterpart of ``littlemcmc_tpu/models/logistic.py:23-136``. The benchmark
is German credit (about 25 parameters); the repository generates a
fixed-seed synthetic design of the same shape (1000 rows, 24 features and
an intercept) with :func:`german_credit_synthetic`, from the same
``np.random.RandomState`` calls as the JAX package, so both packages
sample the same data to the bit. ``q = [intercept, beta...]`` with a
``N(0, prior_scale^2)`` prior on each.

``batched_logp_grad`` runs the plain PyTorch model, or with
``use_kernel=True`` the batched CUDA kernel
(:func:`~littlemcmc_torch.ops.logistic.logistic_logp_grad`, which on a CUDA
tensor launches the kernel or raises). ``trajectory_spec`` is the body the
CUDA trajectory kernels inline (``logistic``): the design, ``y`` and the
prior precision, unpadded.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.logistic import logistic_logp_grad, logistic_logp_grad_plain
from ..ops.nuts_trajectory import MAX_KERNEL_NDIM_DENSE, TrajectorySpec

__all__ = ["LogisticRegression", "german_credit_synthetic"]


def german_credit_synthetic(n_rows: int = 1000, n_features: int = 24, seed: int = 7):
    """Fixed-seed synthetic stand-in for the German-credit design matrix:
    ``(X (n_rows, n_features), y (n_rows,))`` float64, correlated and
    standardized features, ``y`` in {0, 1}."""
    rng = np.random.RandomState(seed)
    L = np.tril(rng.randn(n_features, n_features) * 0.3) + np.eye(n_features)
    X = rng.randn(n_rows, n_features) @ L.T
    X = (X - X.mean(0)) / X.std(0)
    beta_true = rng.randn(n_features) * 0.5
    logits = X @ beta_true + 0.3
    y = (rng.rand(n_rows) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float64)
    return X, y


class LogisticRegression:
    """Bayesian logistic regression with a ``N(0, prior_scale^2)`` prior;
    ``ndim = n_features + 1``.

    ``use_kernel``: ``batched_logp_grad`` calls the batched CUDA kernel
    (the counterpart of the JAX model's ``use_pallas``). Models of more
    than 256 parameters have no trajectory spec (the kernels hold at most
    256 gradient columns a warp) and run NUTS on the tensor-op tree. A
    float64 position is evaluated on tensor ops with the float64 data.
    """

    def __init__(self, X=None, y=None, prior_scale: float = 10.0, use_kernel: bool = False,
                 device=None):
        self.device = resolve_device(device)
        if X is None:
            X, y = german_credit_synthetic()
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        rows, p = X.shape
        # fold the intercept into the design matrix
        xb = np.concatenate([np.ones((rows, 1)), X], axis=1)
        self.Xb = torch.from_numpy(xb.astype(np.float32)).to(self.device)
        self.y = torch.from_numpy(y.astype(np.float32)).to(self.device)
        self.ndim = p + 1
        self.prior_scale = float(prior_scale)
        self.prior_prec = torch.tensor([1.0 / self.prior_scale ** 2], dtype=torch.float32,
                                       device=self.device)
        self.use_kernel = bool(use_kernel)
        self._spec = TrajectorySpec("logistic", (self.Xb, self.y, self.prior_prec), self.ndim)
        self._data64 = (xb, y)
        self._consts64 = None

    def _consts(self, dtype):
        """``(Xb, y, prior_prec)`` in ``dtype`` (the float64 ones from the
        float64 data)."""
        if dtype == torch.float32:
            return self.Xb, self.y, self.prior_prec
        if self._consts64 is None:
            xb, y = (torch.from_numpy(a).to(self.device) for a in self._data64)
            self._consts64 = (xb, y, torch.tensor([1.0 / self.prior_scale ** 2],
                                                  dtype=torch.float64, device=self.device))
        return tuple(c.to(dtype) for c in self._consts64)

    def logp(self, q: torch.Tensor) -> torch.Tensor:
        return self.logp_grad(q)[0]

    def logp_grad(self, q: torch.Tensor):
        """``(logp, grad)`` at one chain's ``(ndim,)`` position."""
        logp, grad = logistic_logp_grad_plain(q[None], *self._consts(q.dtype))
        return logp[0], grad[0]

    def batched_logp_grad(self, q: torch.Tensor):
        """``(logp (C,), grad (C, ndim))`` for ``q: (C, ndim)``."""
        if self.use_kernel and q.dtype == torch.float32:
            return logistic_logp_grad(q, self.Xb, self.y, self.prior_prec,
                                      packed=self._spec.kernel_consts)
        return logistic_logp_grad_plain(q, *self._consts(q.dtype))

    def trajectory_spec(self):
        """The ``logistic`` body, or None past 256 parameters."""
        return self._spec if self.ndim <= MAX_KERNEL_NDIM_DENSE else None
