"""Neal's funnel, centred and non-centred (BASELINE config 3).

Counterpart of ``littlemcmc_tpu/models/funnel.py:12-141``. The centred
form is the divergence stress test: ``v ~ N(0, scale^2)`` and ``x_i | v ~
N(0, exp(v/2)^2)``, ``q = [v, x_1..x_{n-1}]``; its neck (``v < -2``) is
where a fixed step size diverges. The non-centred form samples ``q = [v~,
x~]`` iid standard normal and :meth:`NonCenteredFunnel.transform` maps a
draw to the funnel's ``(v, x)``.

The centred funnel's body (``funnel``) is the one the CUDA kernels inline:
``logp = -v^2/(2 s^2) - (n-1) v/2 - e sq/2`` with ``sq = sum_{i>=1} x_i^2``
summed on its own, not as ``q.q - v^2`` (that cancellation is what makes
float32 chaotic in the neck) and ``e = exp(-v)``; its one constant is
``[1/scale^2]``. The non-centred form's body is the standard normal's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.nuts_trajectory import TrajectorySpec, body_logp_grad

__all__ = ["NealsFunnel", "NonCenteredFunnel"]


class NealsFunnel:
    """Neal's funnel, centred: ``q[0] = v``, ``q[1:] = x``."""

    def __init__(self, ndim: int = 10, scale: float = 3.0, device=None):
        if ndim < 2:
            raise ValueError(f"the funnel needs ndim >= 2, got {ndim}")
        self.ndim = int(ndim)
        self.scale = float(scale)
        self.device = resolve_device(device)
        # exact marginals: v ~ N(0, scale^2); x_i has variance E[exp(v)]
        self.true_mean = np.zeros(self.ndim)
        self.true_var = np.concatenate(
            [[self.scale ** 2], np.full(self.ndim - 1, np.exp(self.scale ** 2 / 2.0))])
        inv_s2 = torch.tensor([1.0 / self.scale ** 2], dtype=torch.float32, device=self.device)
        self._spec = TrajectorySpec("funnel", (inv_s2,), self.ndim, packable=True)

    def logp(self, q: torch.Tensor) -> torch.Tensor:
        return self.logp_grad(q)[0]

    def logp_grad(self, q: torch.Tensor):
        """``(logp, grad)`` at one chain's ``(n,)`` position."""
        logp, grad = body_logp_grad(self._spec, q[None])
        return logp[0], grad[0]

    def batched_logp_grad(self, q: torch.Tensor):
        """``(logp (C,), grad (C, n))`` for ``q: (C, n)``."""
        return body_logp_grad(self._spec, q)

    def trajectory_spec(self) -> TrajectorySpec:
        return self._spec


class NonCenteredFunnel:
    """Neal's funnel, non-centred: ``q = [v~, x~]`` iid standard normal,
    ``v = scale v~`` and ``x = exp(v/2) x~`` (:meth:`transform`)."""

    def __init__(self, ndim: int = 10, scale: float = 3.0, device=None):
        if ndim < 2:
            raise ValueError(f"the funnel needs ndim >= 2, got {ndim}")
        self.ndim = int(ndim)
        self.scale = float(scale)
        self.device = resolve_device(device)
        self.true_mean = np.zeros(self.ndim)  # in the sampled (tilde) space
        self.true_var = np.ones(self.ndim)
        self._spec = TrajectorySpec("standard_normal", (), self.ndim, packable=True)

    def logp(self, q: torch.Tensor) -> torch.Tensor:
        return -0.5 * torch.sum(q * q)

    def logp_grad(self, q: torch.Tensor):
        return -0.5 * torch.sum(q * q), -q

    def batched_logp_grad(self, q: torch.Tensor):
        """``(logp (C,), grad (C, n))`` for ``q: (C, n)``."""
        return body_logp_grad(self._spec, q)

    def transform(self, q):
        """Sampled draws (any leading shape; a tensor or an array) in the
        funnel's ``(v, x)`` space."""
        if isinstance(q, torch.Tensor):
            v = self.scale * q[..., :1]
            return torch.cat([v, torch.exp(v / 2.0) * q[..., 1:]], -1)
        q = np.asarray(q)
        v = self.scale * q[..., :1]
        return np.concatenate([v, np.exp(v / 2.0) * q[..., 1:]], -1)

    def trajectory_spec(self) -> TrajectorySpec:
        return self._spec
