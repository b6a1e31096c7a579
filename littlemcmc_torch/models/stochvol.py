"""Stochastic volatility: the classic T-latent-state finance model.

Counterpart of ``littlemcmc_tpu/models/stochvol.py:29-87``: daily returns
``y_t ~ N(0, exp(h_t/2)^2)`` with an AR(1) log-volatility ``h_t = mu + phi
(h_{t-1} - mu) + sigma eps_t``; ``q = [phi_raw, log_sigma, mu, h_1..h_T]``
(``ndim = T + 3``). The AR(1) prior is one vectorized residual row over
the shifted slices ``h[1:]`` and ``h[:-1]``. Its synthetic returns come
from ``np.random.RandomState(seed)`` in the JAX model's order, so both
packages hold the same data to the bit.

On the card the kernels run the body
:func:`~littlemcmc_torch.ops.autospec.make_trajectory_spec` generates from
:meth:`StochasticVolatility.logp` where it lowers (``T + 3 <=
autospec.MAX_NDIM``); above that (``T = 500``, 503 parameters) the model
declines at trace time (:meth:`trajectory_spec` returns None) and runs on
the tensor-op tree.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..model import from_logp_fn
from ..ops.nuts_trajectory import TrajectorySpec

__all__ = ["StochasticVolatility"]


class StochasticVolatility:
    """Centred stochastic volatility on synthetic returns.

    Priors as Stan's user's-guide example: ``(phi+1)/2 ~ Beta(20, 1.5)``,
    ``sigma ~ HalfCauchy(5)``, ``mu ~ Cauchy(0, 10)``; ``phi =
    tanh(phi_raw)`` and ``sigma = exp(log_sigma)`` with their jacobians.
    """

    def __init__(self, T: int = 128, phi: float = 0.97, sigma: float = 0.25,
                 mu: float = -1.0, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.T = int(T)
        self.ndim = self.T + 3
        self.true_phi = float(phi)
        self.true_sigma = float(sigma)
        self.true_mu = float(mu)
        rng = np.random.RandomState(seed)
        h = np.empty(self.T)
        h[0] = mu + sigma / np.sqrt(1 - phi ** 2) * rng.standard_normal()
        for t in range(1, self.T):
            h[t] = mu + phi * (h[t - 1] - mu) + sigma * rng.standard_normal()
        y = np.exp(h / 2) * rng.standard_normal(self.T)
        self.h_true = h
        self.y = y
        self.y2 = torch.from_numpy((y * y).astype(np.float32)).to(self.device)
        self._logp_grad = from_logp_fn(self.logp)
        self._spec = None
        self.decline_reason: Optional[str] = None

    def logp(self, q: torch.Tensor) -> torch.Tensor:
        phi_raw, log_sigma, mu = q[0], q[1], q[2]
        h = q[3:]
        phi = torch.tanh(phi_raw)
        sigma = torch.exp(log_sigma)
        T = self.T

        # priors with the unconstraining jacobians
        lp = (19.0 * torch.log((1.0 + phi) / 2.0)
              + 0.5 * torch.log((1.0 - phi) / 2.0)
              + torch.log(1.0 - phi ** 2))
        lp = lp - torch.log(1.0 + (sigma / 5.0) ** 2) + log_sigma
        lp = lp - torch.log(1.0 + (mu / 10.0) ** 2)

        # AR(1) prior on h (stationary start), one residual row
        e1 = (h[0] - mu) * torch.sqrt(1.0 - phi ** 2) / sigma
        et = (h[1:] - mu - phi * (h[:-1] - mu)) / sigma
        lp = lp - 0.5 * (e1 ** 2 + torch.sum(et ** 2)) \
            - T * log_sigma + 0.5 * torch.log(1.0 - phi ** 2)

        # the returns' likelihood
        lp = lp - 0.5 * torch.sum(h) - 0.5 * torch.sum(self.y2 * torch.exp(-h))
        return lp

    def logp_grad(self, q: torch.Tensor):
        """``(logp, grad)`` at one chain's ``(T + 3,)`` position (autodiff)."""
        return self._logp_grad(q)

    def batched_logp_grad(self, q: torch.Tensor):
        """``(logp (C,), grad (C, T + 3))`` for ``q: (C, T + 3)``: the
        same density as :meth:`logp`, its gradient written out by hand (a
        few vector ops for all chains, where autodiff through a vmap
        replays the graph at every tree leaf)."""
        r, ls, mu, h = q[:, 0], q[:, 1], q[:, 2], q[:, 3:]
        p = torch.tanh(r)
        s = torch.exp(ls)
        one_m_p2 = 1.0 - p * p
        sq = torch.sqrt(one_m_p2)
        s5 = (s / 5.0) ** 2
        m10 = (mu / 10.0) ** 2
        lag = h[:, :-1] - mu[:, None]
        e1 = (h[:, 0] - mu) * sq / s
        et = (h[:, 1:] - mu[:, None] - p[:, None] * lag) / s[:, None]
        ex = self.y2 * torch.exp(-h)
        e2 = e1 * e1 + (et * et).sum(1)
        logp = (19.0 * torch.log((1.0 + p) / 2.0) + 0.5 * torch.log((1.0 - p) / 2.0)
                + torch.log(one_m_p2) - torch.log(1.0 + s5) + ls - torch.log(1.0 + m10)
                - 0.5 * e2 - self.T * ls + 0.5 * torch.log(one_m_p2)
                - 0.5 * h.sum(1) - 0.5 * ex.sum(1))
        # d/dphi: the priors' and jacobians' terms, then the residuals'
        d_phi = (19.0 / (1.0 + p) - 0.5 / (1.0 - p) - 3.0 * p / one_m_p2
                 + e1 * (h[:, 0] - mu) * p / (sq * s) + (et * lag).sum(1) / s)
        g_r = d_phi * one_m_p2
        g_ls = 1.0 - self.T - 2.0 * s5 / (1.0 + s5) + e2
        g_mu = (-0.02 * mu / (1.0 + m10) + e1 * sq / s
                + (et * (1.0 - p[:, None])).sum(1) / s)
        g_h = -0.5 + 0.5 * ex
        g_h[:, 0] -= e1 * sq / s
        g_h[:, 1:] -= et / s[:, None]
        g_h[:, :-1] += et * (p / s)[:, None]
        return logp, torch.cat([g_r[:, None], g_ls[:, None], g_mu[:, None], g_h], 1)

    def trajectory_spec(self) -> Optional[TrajectorySpec]:
        """The body generated from :meth:`logp` (traced once), or None
        where the model declines (``decline_reason`` says why)."""
        if self._spec is None and self.decline_reason is None:
            from ..ops.autospec import Decline, make_trajectory_spec

            try:
                self._spec = make_trajectory_spec(ndim=self.ndim, logp_fn=self.logp,
                                                  device=self.device,
                                                  name="StochasticVolatility.logp")
            except Decline as e:
                self.decline_reason = str(e)
        return self._spec
