"""Cross-chain mass-matrix adaptation: pool Welford statistics over chains.

Counterpart of ``littlemcmc_tpu/parallel/cross_chain.py``: the pooled
moments (``:29-50``), the low-rank metric's batch subspace iteration
``_pooled_lowrank`` (``:53-94``) and its chunk-boundary refresh
``lowrank_boundary_refresh`` (``:97-143``), and
``cross_chain_potential_pool`` (``:145-186``).
Each chain keeps its own Welford accumulators (so window swaps stay
exact); only the metric (``var``/``stds`` or ``cov``/``chol``) is
recomputed from the cross-chain pooled moments. Pooled moments use the
parallel Welford combination (Chan et al.): ``W = sum w_c``,
``M = sum w_c m_c / W``, ``raw = sum raw_c + sum w_c (m_c - M)(m_c - M)^T``.
The pooled diagonal (and the pooled low-rank factor) is stored as one row
``expand``-ed over the chains.
"""

from __future__ import annotations

import dataclasses

import torch

from ..quadpotential import (QuadPotentialDiagAdapt, QuadPotentialFullAdapt,
                             QuadPotentialLowRankAdapt, _effective_eigenvalues,
                             _orthonormal_columns, cholesky_or_keep)
from ..math import fp32_matmul

__all__ = ["cross_chain_potential_pool", "lowrank_boundary_refresh"]


def _pooled_diag_moments(pot: QuadPotentialDiagAdapt):
    """Pooled ``(mean, var)`` from chain-batched diag Welford foregrounds."""
    w = pot.fg.w_sum  # (C,)
    W = torch.sum(w)
    M = torch.sum(w[:, None] * pot.fg.mean, dim=0) / W
    raw = torch.sum(pot.fg.raw_var, dim=0) + torch.sum(
        w[:, None] * (pot.fg.mean - M) ** 2, dim=0)
    return M, raw / W  # biased (divide-by-W), matching the per-chain estimator


def _pooled_diag(pot: QuadPotentialDiagAdapt) -> torch.Tensor:
    return _pooled_diag_moments(pot)[1]


def _pooled_cov(pot: QuadPotentialFullAdapt) -> torch.Tensor:
    n = pot.fg.n_samples  # (C,)
    N = torch.sum(n)
    M = torch.sum(n[:, None] * pot.fg.mean, dim=0) / N
    d = pot.fg.mean - M  # (C, n)
    raw = torch.sum(pot.fg.raw_cov, dim=0) + torch.einsum("c,ci,cj->ij", n, d, d)
    return raw / (N - 1.0)


def _pooled_diag_fields(pot, var: torch.Tensor) -> dict:
    """The pooled diagonal ``var`` as every chain's ``var``/``stds``/``inv_stds``."""
    C = pot.var.shape[0]
    var = var.expand(C, -1)
    stds = torch.sqrt(var)
    return dict(var=var, stds=stds, inv_stds=1.0 / stds)


def _pooled_lowrank(pot: QuadPotentialLowRankAdapt, samples: torch.Tensor,
                    inner: int = 1) -> QuadPotentialLowRankAdapt:
    """The pooled low-rank metric (reference ``cross_chain.py:53-94``): the
    pooled diagonal, ``inner`` shifted subspace-iteration steps
    ``V ← orth(V + Zᵀ(ZV)/C)`` on the standardized cross-chain batch
    ``samples`` ``(C, n)`` from the orthonormalized mean of the chains'
    bases, and the chains' eigenvalue accumulators averaged."""
    M, var = _pooled_diag_moments(pot)
    Z = (samples - M) * (1.0 / torch.sqrt(var))  # (C, n)
    C = samples.shape[0]
    V = _orthonormal_columns(torch.mean(pot.vecs, dim=0))
    for _ in range(max(1, int(inner))):
        V = _orthonormal_columns(V + fp32_matmul(Z.T, fp32_matmul(Z, V)) / C)
    lam_w = torch.mean(pot.lam_w)
    lam_s2 = torch.mean(pot.lam_s2, dim=0)
    alpha_s2 = torch.mean(pot.alpha_s2)
    n_resid = max(samples.shape[1] - pot.rank, 1)
    Cn = pot.var.shape[0]

    def b(x):
        return x.expand(Cn, *x.shape)

    return pot.replace(
        **_pooled_diag_fields(pot, var), vecs=b(V),
        lam=b(_effective_eigenvalues(lam_s2, lam_w, pot.lam_clip)),
        alpha=b(_effective_eigenvalues(alpha_s2 / n_resid, lam_w, pot.lam_clip)),
        lam_w=b(lam_w), lam_s2=b(lam_s2), alpha_s2=b(alpha_s2))


def lowrank_boundary_refresh(pot: QuadPotentialLowRankAdapt,
                             samples: torch.Tensor) -> QuadPotentialLowRankAdapt:
    """The fused engine's chunk-boundary low-rank refresh (reference
    ``cross_chain.py:97-143``). The fused kernels freeze the shared factor
    for a chunk, so the eigenvalue accumulators see no per-draw
    projections there: each boundary adds one batch observation of weight
    ``C``, the cross-chain mean of the final draw's squared projections on
    the previous basis, after a 0.5 decay, then runs the pooled refresh
    with three inner subspace-iteration steps."""
    M, var = _pooled_diag_moments(pot)
    Z = (samples - M) * (1.0 / torch.sqrt(var))  # (C, n)
    C = float(samples.shape[0])
    V0 = _orthonormal_columns(torch.mean(pot.vecs, dim=0))
    c2 = torch.mean(fp32_matmul(Z, V0) ** 2, dim=0)  # (k,)
    r2m = torch.clamp(torch.mean(torch.sum(Z * Z, dim=1)) - torch.sum(c2), min=0.0)
    decay = 0.5
    Cn = pot.var.shape[0]

    def b(x):
        return x.expand(Cn, *x.shape)

    pot = pot.replace(lam_w=b(torch.mean(pot.lam_w) * decay + C),
                      lam_s2=b(torch.mean(pot.lam_s2, dim=0) * decay + C * c2),
                      alpha_s2=b(torch.mean(pot.alpha_s2) * decay + C * r2m))
    return _pooled_lowrank(pot, samples, inner=3)


def cross_chain_potential_pool(potential, tuning: bool, samples: torch.Tensor | None = None):
    """Overwrite each chain's metric with the cross-chain pooled estimate.

    ``potential`` is a chain-batched metric (leading axis = chains). A
    no-op for static metrics and when ``tuning`` is False. A failed
    Cholesky factorization of the pooled covariance keeps every chain's
    previous factor. ``samples`` (the chains' positions after this step,
    ``(C, n)``) feeds the low-rank metric's batch subspace iteration;
    without it the low-rank branch pools only the diagonal.
    """
    if not tuning:
        return potential
    if isinstance(potential, QuadPotentialLowRankAdapt):
        if samples is not None:
            return _pooled_lowrank(potential, samples)
        return potential.replace(**_pooled_diag_fields(potential, _pooled_diag(potential)))
    if isinstance(potential, QuadPotentialDiagAdapt):
        return dataclasses.replace(potential,
                                   **_pooled_diag_fields(potential, _pooled_diag(potential)))
    if isinstance(potential, QuadPotentialFullAdapt):
        cov = _pooled_cov(potential)  # (n, n)
        chol, ok = cholesky_or_keep(cov, potential.chol)  # broadcast over chains
        return dataclasses.replace(potential, cov=torch.where(ok, cov, potential.cov),
                                   chol=chol)
    return potential
