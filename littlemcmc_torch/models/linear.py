"""3-parameter linear regression: the reference's cross-framework test model.

Counterpart of ``littlemcmc_tpu/models/linear.py:17-45`` (the model of the
reference's framework cookbook and ``tests/test_various_frameworks.py``:
``y = b0 + b1 x + N(0, exp(2 log_sigma))``, true parameters ``[0.5, 2.0,
log 0.5]``). Its data come from ``np.random.RandomState(seed)`` in the JAX
model's order, so both packages hold the same data to the bit. The CUDA
kernels run the body :func:`~littlemcmc_torch.ops.autospec.
make_trajectory_spec` generates from :meth:`LinearRegression.logp`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..model import from_logp_fn
from ..ops.nuts_trajectory import TrajectorySpec

__all__ = ["LinearRegression"]


class LinearRegression:
    """Gaussian linear regression with flat priors; ``q = [b0, b1, log_sigma]``."""

    ndim = 3

    def __init__(self, n_points: int = 50, seed: int = 0, device=None):
        self.device = resolve_device(device)
        rng = np.random.RandomState(seed)
        x = np.linspace(-1, 1, n_points)
        true = dict(b0=0.5, b1=2.0, sigma=0.5)
        y = true["b0"] + true["b1"] * x + true["sigma"] * rng.randn(n_points)
        self.x = torch.from_numpy(x.astype(np.float32)).to(self.device)
        self.y = torch.from_numpy(y.astype(np.float32)).to(self.device)
        self.true_params = np.array([true["b0"], true["b1"], np.log(true["sigma"])])
        self._logp_grad = from_logp_fn(self.logp)
        self._spec = None

    def logp(self, q: torch.Tensor) -> torch.Tensor:
        b0, b1, log_sigma = q[0], q[1], q[2]
        mu = b0 + b1 * self.x
        n = self.x.shape[0]
        return -n * log_sigma - 0.5 * torch.sum((self.y - mu) ** 2) * torch.exp(-2.0 * log_sigma)

    def logp_grad(self, q: torch.Tensor):
        """``(logp, grad)`` at one chain's ``(3,)`` position (autodiff)."""
        return self._logp_grad(q)

    def batched_logp_grad(self, q: torch.Tensor):
        """``(logp (C,), grad (C, 3))`` for ``q: (C, 3)``."""
        return torch.func.vmap(self._logp_grad)(q)

    def posterior_moments(self) -> dict:
        """The flat-prior posterior's means and sds in closed form: ``(b0,
        b1)`` is Student-t on ``n - 2`` degrees of freedom about the least
        squares fit with scale ``s^2 (X^T X)^-1``, ``s^2 = SSR / (n - 2)``;
        ``sigma^2 (n - 2) s^2 / chi^2_{n-2}``, so ``log_sigma`` has mean
        ``(log((n-2) s^2 / 2) - digamma((n-2)/2)) / 2`` and sd
        ``sqrt(trigamma((n-2)/2)) / 2``."""
        x = self.x.double().cpu()
        y = self.y.double().cpu()
        X = torch.stack([torch.ones_like(x), x], 1)
        xtx = X.T @ X
        b = torch.linalg.solve(xtx, X.T @ y)
        k = x.shape[0] - 2
        s2 = float(((y - X @ b) ** 2).sum()) / k
        cov_b = s2 * torch.linalg.inv(xtx) * k / (k - 2)
        half = torch.tensor(k / 2.0, dtype=torch.float64)
        mean = np.array([float(b[0]), float(b[1]),
                         0.5 * (np.log(k * s2 / 2.0) - float(torch.digamma(half)))])
        sd = np.array([float(cov_b[0, 0]) ** 0.5, float(cov_b[1, 1]) ** 0.5,
                       0.5 * float(torch.polygamma(1, half)) ** 0.5])
        return {"mean": mean, "sd": sd}

    def trajectory_spec(self) -> TrajectorySpec:
        """The body generated from :meth:`logp` (traced once)."""
        if self._spec is None:
            from ..ops.autospec import make_trajectory_spec

            self._spec = make_trajectory_spec(ndim=self.ndim, logp_fn=self.logp,
                                              device=self.device, name="LinearRegression.logp")
        return self._spec
