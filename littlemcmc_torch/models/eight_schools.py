"""Hierarchical eight schools, non-centred (BASELINE config 5).

Counterpart of ``littlemcmc_tpu/models/eight_schools.py:21-141``. The
classic data (Rubin 1981): treatment-effect estimates ``y`` and standard
errors ``sigma`` of eight schools. ``q = [mu, log_tau, theta_tilde_1..8]``
(10 parameters), ``theta_i = mu + exp(log_tau) * theta_tilde_i``, with
``mu ~ N(0, 5)``, ``log_tau ~ N(0, 5)``, ``theta_tilde ~ N(0, 1)`` and
``y_i ~ N(theta_i, sigma_i)``. The model body the CUDA kernels inline
reads one ``(2, 10)`` float32 constant, ``y`` and ``1/sigma^2`` in the
theta columns 2..9, so the kernel and the plain body read the same
numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.nuts_trajectory import TrajectorySpec, body_logp_grad

__all__ = ["EightSchools"]

_Y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
_SIGMA = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])


class EightSchools:
    """Non-centred eight schools with N(0, 5) priors on mu and log_tau."""

    ndim = 10

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.y, self.sigma = _Y.copy(), _SIGMA.copy()
        consts = np.zeros((2, self.ndim), np.float32)
        consts[0, 2:] = _Y
        consts[1, 2:] = 1.0 / _SIGMA ** 2
        self.consts = torch.from_numpy(consts).to(self.device)
        self._spec = TrajectorySpec("eight_schools", (self.consts,), self.ndim, packable=True)

    def logp(self, q: torch.Tensor) -> torch.Tensor:
        return self.logp_grad(q)[0]

    def logp_grad(self, q: torch.Tensor):
        """``(logp, grad)`` at one chain's ``(10,)`` position."""
        logp, grad = body_logp_grad(self._spec, q[None])
        return logp[0], grad[0]

    def batched_logp_grad(self, q: torch.Tensor):
        """``(logp (C,), grad (C, 10))`` for ``q: (C, 10)``."""
        return body_logp_grad(self._spec, q)

    def trajectory_spec(self) -> TrajectorySpec:
        return self._spec

    def exact_moments(self, mu_grid=(-40.0, 50.0, 1801),
                      log_tau_grid=(-35.0, 15.0, 2001)) -> dict:
        """Posterior mean and sd of ``mu`` and ``log_tau`` by quadrature in
        float64 on a 2-D grid, with ``theta`` integrated out
        (``y_i ~ N(mu, sigma_i^2 + tau^2)``): ``{"mu": (mean, sd),
        "log_tau": (mean, sd)}``. On the default grid the mass within five
        points of its edges is below 1e-12."""
        mu = np.linspace(*mu_grid)
        lt = np.linspace(*log_tau_grid)
        v = self.sigma[None, :] ** 2 + np.exp(2.0 * lt)[:, None]  # (L, 8)
        loglik = (-0.5 * ((self.y - mu[:, None]) ** 2 / v[:, None, :]).sum(-1)
                  - 0.5 * np.log(v).sum(-1)[:, None])  # (L, M)
        logp = loglik - 0.5 * (mu[None, :] / 5.0) ** 2 - 0.5 * (lt[:, None] / 5.0) ** 2
        w = np.exp(logp - logp.max())
        w /= w.sum()
        out = {}
        for name, x in (("mu", mu[None, :]), ("log_tau", lt[:, None])):
            mean = float((w * x).sum())
            out[name] = (mean, float(np.sqrt((w * (x - mean) ** 2).sum())))
        return out
