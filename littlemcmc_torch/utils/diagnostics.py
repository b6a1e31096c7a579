"""Convergence diagnostics: rank-normalized split R-hat and bulk ESS.

Counterpart of ``littlemcmc_tpu/utils/diagnostics.py``. The reference has
no diagnostics (users are pointed at ArviZ); the port needs them in-tree
for its convergence checks and for effective samples per second.
Implements the rank-normalized split-R̂ and bulk-ESS of Vehtari et al.
(2021), with Geyer's initial monotone positive sequence for the
autocorrelation truncation — the same estimators ArviZ uses.

Host-side NumPy: these run once per sampling run on the gathered trace.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["split_rhat", "ess_bulk", "bfmi", "to_arviz", "summary"]


def _split_chains(x: np.ndarray) -> np.ndarray:
    """(chains, draws) -> (2*chains, draws//2), dropping an odd last draw."""
    c, n = x.shape
    half = n // 2
    return np.concatenate([x[:, :half], x[:, n - half:]], axis=0)


def _rank_normalize(x: np.ndarray) -> np.ndarray:
    """Fractional ranks -> inverse-normal (Blom) transform, per Vehtari et al."""
    shape = x.shape
    flat = x.ravel()
    ranks = np.argsort(np.argsort(flat)).astype(np.float64) + 1.0
    u = (ranks - 0.375) / (flat.size + 0.25)
    z = _ndtri(u)
    return z.reshape(shape)


def _ndtri(p: np.ndarray) -> np.ndarray:
    """Inverse standard-normal CDF (Acklam's rational approximation).

    Avoids a scipy dependency; max abs error ~1.15e-9, far below the MC
    noise these diagnostics operate on.
    """
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    p = np.asarray(p, np.float64)
    x = np.empty_like(p)
    plow, phigh = 0.02425, 1 - 0.02425

    lo = p < plow
    hi = p > phigh
    mid = ~(lo | hi)

    if lo.any():
        q = np.sqrt(-2 * np.log(p[lo]))
        x[lo] = (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / (
            (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1
        )
    if hi.any():
        q = np.sqrt(-2 * np.log(1 - p[hi]))
        x[hi] = -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / (
            (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1
        )
    if mid.any():
        q = p[mid] - 0.5
        r = q * q
        x[mid] = (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / (
            ((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1
        )
    return x


def _rhat_from_z(z: np.ndarray) -> float:
    """Split R-hat on already-transformed (chains, draws) values."""
    z = _split_chains(z)
    c, n = z.shape
    if n < 2:
        return np.nan
    chain_means = z.mean(axis=1)
    chain_vars = z.var(axis=1, ddof=1)
    W = chain_vars.mean()
    B = n * chain_means.var(ddof=1)
    var_plus = (n - 1) / n * W + B / n
    if W <= 0:
        return np.nan
    return float(np.sqrt(var_plus / W))


def split_rhat(x: np.ndarray, rank_normalized: bool = True) -> float:
    """Rank-normalized split R-hat for one parameter, ``x: (chains, draws)``.

    >>> rng = np.random.default_rng(0)
    >>> mixed = rng.normal(size=(4, 500))
    >>> bool(split_rhat(mixed) < 1.01)
    True
    >>> stuck = mixed + np.arange(4)[:, None]  # chains at different levels
    >>> bool(split_rhat(stuck) > 1.2)
    True
    """
    x = np.asarray(x, np.float64)
    if rank_normalized:
        x = _rank_normalize(x)
    return _rhat_from_z(x)


def _autocov_fft(z: np.ndarray) -> np.ndarray:
    """Per-chain autocovariance via FFT; z: (chains, draws)."""
    c, n = z.shape
    z = z - z.mean(axis=1, keepdims=True)
    m = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(z, m, axis=1)
    acov = np.fft.irfft(f * np.conj(f), m, axis=1)[:, :n].real
    return acov / n


def ess_bulk(x: np.ndarray, rank_normalized: bool = True) -> float:
    """Bulk effective sample size for one parameter, ``x: (chains, draws)``.

    Combined-chain autocorrelation with Geyer's initial monotone positive
    sequence truncation (Vehtari et al. 2021, §3.2).
    """
    x = np.asarray(x, np.float64)
    if rank_normalized:
        x = _rank_normalize(x)
    z = _split_chains(x)
    c, n = z.shape
    if n < 4:
        return np.nan

    acov = _autocov_fft(z)
    chain_var = acov[:, 0] * n / (n - 1.0)
    mean_var = chain_var.mean()
    var_plus = mean_var * (n - 1.0) / n
    if c > 1:
        var_plus += z.mean(axis=1).var(ddof=1)
    if var_plus <= 0:
        return np.nan

    rho = 1.0 - (mean_var - acov.mean(axis=0)) / var_plus
    rho[0] = 1.0

    # Geyer: sum consecutive pairs while positive, enforce monotone decrease.
    max_t = n - 2 if n % 2 == 0 else n - 3
    pair = rho[1:max_t + 1:2] + rho[2:max_t + 2:2]
    tau = 1.0 + 2.0 * rho[0] - 2.0  # placeholder, recomputed below
    positive = pair > 0
    if not positive.any():
        k = 0
    else:
        # first index where the pair sum goes non-positive
        nonpos = np.where(~positive)[0]
        k = nonpos[0] if nonpos.size else positive.size
    pair = pair[:k]
    # monotone decreasing envelope
    pair = np.minimum.accumulate(pair) if pair.size else pair
    tau = -1.0 + 2.0 * rho[0] + 2.0 * pair.sum()
    tau = max(tau, 1.0 / np.log10(c * n + 10.0))  # guard against tau < tiny
    return float(c * n / tau)


def bfmi(energy: np.ndarray) -> np.ndarray:
    """Bayesian fraction of missing information, per chain.

    ``energy``: (chains, draws) Hamiltonian energies (the ``energy`` stat).
    Values well below ~0.3 indicate the momentum resampling cannot explore
    the energy marginal (e.g. heavy tails). The reference exposes the
    energy stat but no BFMI computation.
    """
    energy = np.asarray(energy, np.float64)
    diff_var = np.var(np.diff(energy, axis=1), axis=1)
    energy_var = np.var(energy, axis=1)
    return diff_var / energy_var


def to_arviz(trace: np.ndarray, stats: Optional[Dict[str, np.ndarray]] = None,
             var_name: str = "x"):
    """A run as an ``arviz.InferenceData`` (``arviz`` is imported here, at
    the call; the JAX package's ``to_arviz``, the reference cookbook's
    bridge, ``docs/tutorials/framework_cookbook.rst:200-206``)."""
    import arviz as az

    sample_stats = None
    if stats is not None:
        rename = {"mean_tree_accept": "acceptance_rate", "depth": "tree_depth",
                  "diverging": "diverging", "energy": "energy",
                  "step_size": "step_size", "tree_size": "n_steps"}
        sample_stats = {rename.get(k, k): np.asarray(v) for k, v in stats.items()}
    return az.from_dict(posterior={var_name: np.asarray(trace)}, sample_stats=sample_stats)


def summary(trace: np.ndarray, stats: Optional[Dict[str, np.ndarray]] = None) -> Dict[str, np.ndarray]:
    """Per-parameter mean/std/R-hat/ESS table for a (chains, draws, ndim) trace."""
    trace = np.asarray(trace)
    chains, draws, ndim = trace.shape
    out = {
        "mean": trace.mean(axis=(0, 1)),
        "std": trace.std(axis=(0, 1)),
        "rhat": np.array([split_rhat(trace[:, :, i]) for i in range(ndim)]),
        "ess_bulk": np.array([ess_bulk(trace[:, :, i]) for i in range(ndim)]),
    }
    if stats is not None and "diverging" in stats:
        out["n_divergences"] = np.asarray(stats["diverging"]).sum()
    return out
