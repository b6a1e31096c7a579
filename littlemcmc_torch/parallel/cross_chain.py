"""Cross-chain mass-matrix adaptation: pool Welford statistics over chains.

Counterpart of ``littlemcmc_tpu/parallel/cross_chain.py:29-50`` and the
diag and dense branches of ``cross_chain_potential_pool`` (``:145-186``).
Each chain keeps its own Welford accumulators (so window swaps stay
exact); only the metric (``var``/``stds`` or ``cov``/``chol``) is
recomputed from the cross-chain pooled moments. Pooled moments use the
parallel Welford combination (Chan et al.): ``W = sum w_c``,
``M = sum w_c m_c / W``, ``raw = sum raw_c + sum w_c (m_c - M)(m_c - M)^T``.
The pooled diagonal is stored as one row ``expand``-ed over the chains.
The low-rank branch is ROADMAP Queue 1 item 12.
"""

from __future__ import annotations

import dataclasses

import torch

from ..quadpotential import QuadPotentialDiagAdapt, QuadPotentialFullAdapt, cholesky_or_keep

__all__ = ["cross_chain_potential_pool"]


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


def cross_chain_potential_pool(potential, tuning: bool):
    """Overwrite each chain's metric with the cross-chain pooled estimate.

    ``potential`` is a chain-batched metric (leading axis = chains). A
    no-op for static metrics and when ``tuning`` is False. A failed
    Cholesky factorization of the pooled covariance keeps every chain's
    previous factor.
    """
    if not tuning:
        return potential
    if isinstance(potential, QuadPotentialDiagAdapt):
        C = potential.var.shape[0]
        var = _pooled_diag(potential).expand(C, -1)
        stds = torch.sqrt(var)
        return dataclasses.replace(potential, var=var, stds=stds, inv_stds=1.0 / stds)
    if isinstance(potential, QuadPotentialFullAdapt):
        cov = _pooled_cov(potential)  # (n, n)
        chol, ok = cholesky_or_keep(cov, potential.chol)  # broadcast over chains
        return dataclasses.replace(potential, cov=torch.where(ok, cov, potential.cov),
                                   chol=chol)
    return potential
