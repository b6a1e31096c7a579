"""Group-indexed hierarchical regression (random intercepts).

Counterpart of ``littlemcmc_tpu/models/hierarchical.py:26-89``: observations
indexed into groups (``z[g]``) with partial pooling, the common shape of a
user's Bayesian model and the showcase of the auto-lowering
(:mod:`littlemcmc_torch.ops.autospec`). Its data come from
``np.random.RandomState(seed)`` in the JAX model's order, so both packages
hold the same data to the bit.

Non-centred: ``q = [mu, log_tau, b (p), z (J)]``, group intercepts
``a_j = mu + tau z_j``, ``tau = exp(log_tau)``; ``y_i ~ N(mu + tau z[g_i]
+ x_i . b, sigma)``, ``z_j ~ N(0, 1)``, ``b ~ N(0, 1)``, ``mu ~ N(0, 5)``,
``log_tau ~ N(0, 1)``. ``logp`` is written as a user would write it (the
group gather ``z[g]``, whose gradient holds the scatter-add); the CUDA
kernels run the body :func:`~littlemcmc_torch.ops.autospec.
make_trajectory_spec` generates from it (``trajectory_spec``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..model import from_logp_fn
from ..ops.nuts_trajectory import TrajectorySpec

__all__ = ["HierarchicalRegression"]


class HierarchicalRegression:
    """Random-intercept Gaussian regression on synthetic grouped data."""

    def __init__(self, n_groups: int = 32, n_rows: int = 512, n_features: int = 8,
                 sigma: float = 0.5, seed: int = 11, device=None):
        self.device = resolve_device(device)
        rng = np.random.RandomState(seed)
        g = rng.randint(0, n_groups, n_rows)
        X = rng.randn(n_rows, n_features)
        X = (X - X.mean(0)) / X.std(0)
        self.true_mu = 0.4
        self.true_tau = 0.8
        self.true_b = rng.randn(n_features) * 0.5
        self.true_z = rng.randn(n_groups)
        y = (self.true_mu + self.true_tau * self.true_z[g]
             + X @ self.true_b + sigma * rng.randn(n_rows))

        self.g = torch.from_numpy(g.astype(np.int64)).to(self.device)
        self.X = torch.from_numpy(X.astype(np.float32)).to(self.device)
        self.y = torch.from_numpy(y.astype(np.float32)).to(self.device)
        self.sigma = float(sigma)
        self.n_groups = int(n_groups)
        self.n_features = int(n_features)
        self.ndim = 2 + n_features + n_groups
        self._logp_grad = from_logp_fn(self.logp)
        self._spec = None

    def _split(self, q):
        p = self.n_features
        return q[0], q[1], q[2:2 + p], q[2 + p:]

    def logp(self, q: torch.Tensor) -> torch.Tensor:
        mu, log_tau, b, z = self._split(q)
        tau = torch.exp(log_tau)
        pred = mu + tau * z[self.g] + self.X @ b
        inv_s2 = 1.0 / self.sigma ** 2
        loglik = -0.5 * inv_s2 * torch.sum((self.y - pred) ** 2)
        logprior = (-0.5 * torch.sum(z ** 2) - 0.5 * torch.sum(b ** 2)
                    - 0.5 * (mu / 5.0) ** 2 - 0.5 * log_tau ** 2)
        return loglik + logprior

    def logp_grad(self, q: torch.Tensor):
        """``(logp, grad)`` at one chain's ``(n,)`` position (autodiff)."""
        return self._logp_grad(q)

    def batched_logp_grad(self, q: torch.Tensor):
        """``(logp (C,), grad (C, n))`` for ``q: (C, n)``."""
        return torch.func.vmap(self._logp_grad)(q)

    def trajectory_spec(self) -> TrajectorySpec:
        """The body generated from :meth:`logp` (traced once)."""
        if self._spec is None:
            from ..ops.autospec import make_trajectory_spec

            self._spec = make_trajectory_spec(ndim=self.ndim, logp_fn=self.logp,
                                              device=self.device,
                                              name="HierarchicalRegression.logp")
        return self._spec
