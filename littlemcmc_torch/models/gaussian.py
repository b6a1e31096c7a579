"""Gaussian targets: the iid standard normal, the correlated Gaussian and
the spiked Gaussian.

Counterpart of ``littlemcmc_tpu/models/gaussian.py:20-237`` (BASELINE
configs 1 and 2, and the low-rank metric's target). Each is built from
numpy exactly as the JAX model is, so the correlated Gaussian's fp32
precision matrix and the spiked Gaussian's basis and scales are
bit-identical to the JAX model's. ``logp_grad`` takes one chain's ``(n,)`` position,
``batched_logp_grad`` a ``(C, n)`` batch (for the correlated Gaussian with
``use_kernel=True`` the batched CUDA kernel
:func:`~littlemcmc_torch.ops.quadform.quadform_logp_grad`), and
``trajectory_spec`` names the model body the CUDA trajectory kernel
inlines. A float64 position (``sample(dtype=torch.float64)``) is evaluated
in float64 on tensor ops, the correlated Gaussian's precision the float64
inverse, as the JAX models' ``dtype``; the kernels stay float32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.nuts_trajectory import TrajectorySpec, body_logp_grad
from ..ops.quadform import quadform_logp_grad, quadform_logp_grad_plain

__all__ = ["StandardNormal", "CorrelatedGaussian", "SpikedGaussian"]


class StandardNormal:
    """iid standard normal in ``ndim`` dimensions (BASELINE config 1)."""

    def __init__(self, ndim: int = 1, device=None):
        self.ndim = int(ndim)
        self.device = resolve_device(device)
        self.true_mean = np.zeros(self.ndim)
        self.true_var = np.ones(self.ndim)
        self._spec = TrajectorySpec("standard_normal", (), self.ndim, packable=True)

    def logp(self, q: torch.Tensor) -> torch.Tensor:
        return -0.5 * torch.sum(q * q)

    def logp_grad(self, q: torch.Tensor):
        return -0.5 * torch.sum(q * q), -q

    def batched_logp_grad(self, q: torch.Tensor):
        """``(logp (C,), grad (C, n))`` for ``q: (C, n)``."""
        return body_logp_grad(self._spec, q)

    def trajectory_spec(self) -> TrajectorySpec:
        return self._spec


def _ar1_correlation(ndim: int, rho: float) -> np.ndarray:
    idx = np.arange(ndim)
    return rho ** np.abs(idx[:, None] - idx[None, :])


class CorrelatedGaussian:
    """Zero-mean Gaussian with AR(1)-correlated covariance (BASELINE config 2).

    ``cov[i, j] = scales[i] * scales[j] * rho^|i-j|``, scales log-uniform
    in ``scale_range`` from ``np.random.RandomState(seed)``. ``use_kernel``:
    ``batched_logp_grad`` calls the batched CUDA kernel (the JAX model's
    ``use_pallas``) on float32 positions.
    """

    def __init__(self, ndim: int = 100, rho: float = 0.9, scale_range=(0.1, 10.0),
                 seed: int = 0, use_kernel: bool = False, device=None):
        self.ndim = int(ndim)
        self.device = resolve_device(device)
        rng = np.random.RandomState(seed)
        log_scales = rng.uniform(np.log(scale_range[0]), np.log(scale_range[1]), ndim)
        scales = np.exp(np.sort(log_scales))
        cov = _ar1_correlation(ndim, rho) * scales[:, None] * scales[None, :]
        self.cov = np.asarray(cov, np.float64)
        self.prec = np.linalg.inv(self.cov)
        self.true_mean = np.zeros(ndim)
        self.true_var = np.diag(self.cov).copy()
        self.prec_f32 = torch.from_numpy(self.prec.astype(np.float32)).to(self.device)
        self.use_kernel = bool(use_kernel)
        self._spec = TrajectorySpec("correlated_gaussian", (self.prec_f32,), self.ndim)
        self._prec_f64 = None

    def logp(self, q: torch.Tensor) -> torch.Tensor:
        return self.logp_grad(q)[0]

    def logp_grad(self, q: torch.Tensor):
        logp, grad = self.batched_logp_grad(q[None], kernel=False)
        return logp[0], grad[0]

    def batched_logp_grad(self, q: torch.Tensor, kernel: bool = True):
        """``(logp (C,), grad (C, n))`` for ``q: (C, n)``: one matmul, or
        one launch of the quadform kernel with ``use_kernel`` (float32)."""
        if q.dtype != torch.float32:
            if self._prec_f64 is None:
                self._prec_f64 = torch.from_numpy(self.prec).to(self.device)
            return quadform_logp_grad_plain(q, self._prec_f64.to(q.dtype))
        if self.use_kernel and kernel:
            return quadform_logp_grad(q, self.prec_f32)
        return body_logp_grad(self._spec, q)

    def trajectory_spec(self) -> TrajectorySpec:
        return self._spec


class SpikedGaussian:
    """Zero-mean Gaussian with spiked covariance ``S(I + V(Λ−I)Vᵀ)S``
    (reference ``models/gaussian.py:140-237``): after standardization ``k``
    spike eigenvalues ``λ`` stay far above 1 while the bulk deflates below
    it, the geometry the low-rank metric (``init="adapt_lowrank"``) is
    built for. ``V`` is the Q of a numpy QR of ``RandomState(seed)``
    normals, the scales log-uniform in ``scale_range``, so both packages
    hold the same numbers. ``logp_grad`` uses the structured precision
    ``Σ⁻¹ = S⁻¹(I + V(λ⁻¹−1)Vᵀ)S⁻¹`` in ``O(nk)``; it is the trajectory
    kernels' body 4."""

    def __init__(self, ndim: int = 100, rank: int = 4, spikes=(400.0, 100.0, 25.0, 9.0),
                 scale_range=(0.1, 10.0), seed: int = 7, device=None):
        self.ndim = int(ndim)
        self.rank = int(rank)
        self.device = resolve_device(device)
        rng = np.random.RandomState(seed)
        V = np.linalg.qr(rng.standard_normal((ndim, self.rank)))[0]
        lam = np.asarray(spikes[: self.rank], np.float64)
        s = np.exp(np.sort(rng.uniform(np.log(scale_range[0]), np.log(scale_range[1]), ndim)))
        self.V, self.lam, self.scales = V, lam, s
        self.true_mean = np.zeros(ndim)
        # diag(Σ) = s² (1 + Σᵢ (λᵢ−1) Vᵢ²)
        self.true_var = s ** 2 * (1.0 + ((lam - 1.0) * V ** 2).sum(axis=1))

        def t(x):
            return torch.from_numpy(np.asarray(x, np.float32)).to(self.device)

        self._spec = TrajectorySpec("spiked_gaussian", (t(V), t(1.0 / lam - 1.0), t(1.0 / s)),
                                    self.ndim)

    def draws(self, z: np.ndarray) -> np.ndarray:
        """Exact draws ``s(z + V((√λ − 1)·(Vᵀz)))`` from standard normals
        ``z`` ``(C, n)``, float32 numpy."""
        return (self.scales * (z + ((z @ self.V) * (np.sqrt(self.lam) - 1.0)) @ self.V.T)
                ).astype(np.float32)

    def logp(self, q: torch.Tensor) -> torch.Tensor:
        return self.logp_grad(q)[0]

    def logp_grad(self, q: torch.Tensor):
        logp, grad = body_logp_grad(self._spec, q[None])
        return logp[0], grad[0]

    def batched_logp_grad(self, q: torch.Tensor):
        """``(logp (C,), grad (C, n))`` for ``q: (C, n)``."""
        return body_logp_grad(self._spec, q)

    def trajectory_spec(self) -> TrajectorySpec:
        return self._spec
