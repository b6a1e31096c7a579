"""Sampler warnings, generated post-hoc from gathered stats arrays.

Counterpart of ``littlemcmc_tpu/report.py:25-240``; the warning taxonomy
matches the reference's ``littlemcmc/report.py:20-37``. Warnings are not
accumulated per draw: :func:`warnings_from_stats` reproduces the
reference's end-of-run aggregation (``base_hmc.py:202-230``,
``nuts.py:226-238``, ``step_sizes.py:101-121``) from the
``(chains, draws)`` stats arrays. Host-side numpy, no scipy.
"""

from __future__ import annotations

import enum
from collections import namedtuple
from typing import Dict, List, Optional

import numpy as np

__all__ = ["SamplerWarning", "WarningType", "warnings_from_stats"]

SamplerWarning = namedtuple("SamplerWarning", "kind, message, level, step, exec_info, extra")


@enum.unique
class WarningType(enum.Enum):
    """Enumeration of sampler warnings (parity with reference ``report.py:23-37``)."""

    # For HMC and NUTS
    DIVERGENCE = 1
    TUNING_DIVERGENCE = 2
    DIVERGENCES = 3
    TREEDEPTH = 4
    # Problematic sampler parameters
    BAD_PARAMS = 5
    # Indications that chains did not converge, eg Rhat
    CONVERGENCE = 6
    BAD_ACCEPTANCE = 7
    BAD_ENERGY = 8


def _betainc(a: float, b: float, x: float) -> float:
    """Regularized incomplete beta ``I_x(a, b)`` without scipy.

    Standard modified-Lentz continued-fraction evaluation with the
    symmetry flip at ``x > (a+1)/(a+b+2)`` for convergence. Scalar,
    host-side; used only by the post-hoc acceptance-rate warning.
    """
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    if x > (a + 1.0) / (a + b + 2.0):
        return 1.0 - _betainc(b, a, 1.0 - x)
    import math

    ln_front = (
        a * math.log(x)
        + b * math.log1p(-x)
        - math.log(a)
        - (math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b))
    )
    tiny = 1e-30
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = 1.0
    d = 1.0 - qab * x / qap
    d = 1.0 / (d if abs(d) > tiny else tiny)
    h = d
    for m in range(1, 200):
        m2 = 2.0 * m
        # even term: +m (b-m) x / ((a+2m-1)(a+2m))
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        d = 1.0 / (d if abs(d) > tiny else tiny)
        c = 1.0 + aa / (c if abs(c) > tiny else tiny)
        h *= d * c
        # odd term: -(a+m)(a+b+m) x / ((a+2m)(a+2m+1))
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        d = 1.0 / (d if abs(d) > tiny else tiny)
        c = 1.0 + aa / (c if abs(c) > tiny else tiny)
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < 1e-14:
            break
    return math.exp(ln_front) * h


def _beta_ppf(q: float, a: float, b: float) -> float:
    """Quantile of Beta(a, b) by bisection on :func:`_betainc`."""
    lo, hi = 0.0, 1.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if _betainc(a, b, mid) < q:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _beta_interval_95(n_good: float, n_bad: float):
    """Central 95% interval of Beta(n_good+1, n_bad+1), exact, scipy-free.

    Matches the reference's ``st.beta(n_good+1, n_bad+1).interval(0.95)``
    (``step_sizes.py:106-110``) via an in-tree incomplete-beta inversion.
    """
    a, b = n_good + 1.0, n_bad + 1.0
    return _beta_ppf(0.025, a, b), _beta_ppf(0.975, a, b)


def warnings_from_stats(
    stats: Dict[str, np.ndarray],
    *,
    target_accept: float = 0.8,
    max_treedepth: Optional[int] = None,
    tune: int = 0,
    trace: Optional[np.ndarray] = None,
) -> List[SamplerWarning]:
    """Aggregate end-of-run warnings from ``(chains, draws)`` stats arrays.

    ``stats`` holds post-tune draws (the default ``sample()`` output);
    when sampled with ``discard_tuned_samples=False``, pass ``tune`` and
    the first ``tune`` columns are excluded from every check (tuning
    transients would otherwise trip the divergence/acceptance/BFMI
    warnings spuriously). Reproduces the divergence-count warning
    (``base_hmc.py:206-227``), the NUTS tree-depth warning
    (``nuts.py:226-238``), and the dual-averaging acceptance-interval
    warning (``step_sizes.py:101-121``); additionally fills in the
    reference's declared-but-unused CONVERGENCE (split R-hat, when
    ``trace`` is given) and BAD_ENERGY (BFMI) warning kinds.
    """
    warns: List[SamplerWarning] = []

    if tune:
        # drop tuning columns from every (chains, draws) stat
        stats = {
            k: np.asarray(v)[:, tune:] if np.ndim(v) == 2 else v
            for k, v in stats.items()
        }
        if trace is not None and np.ndim(trace) == 3:
            trace = np.asarray(trace)[:, tune:, :]

    diverging = np.asarray(stats.get("diverging"))
    n_samples = diverging.size
    n_divs = int(diverging.sum())
    message = ""
    if n_divs and n_samples == n_divs:
        message = "The chain contains only diverging samples. The model is probably misspecified."
    elif n_divs == 1:
        message = "There was 1 divergence after tuning. Increase `target_accept` or reparameterize."
    elif n_divs > 1:
        message = (
            "There were %s divergences after tuning. Increase "
            "`target_accept` or reparameterize." % n_divs
        )
    if message:
        # Per-divergence records: the reference emits one debug-level
        # SamplerWarning per divergence with its iteration index
        # (base_hmc.py:164-179). The batched driver does not interrupt per
        # draw, but the per-draw ``diverging`` stat makes the indices
        # exactly recoverable — carried in ``extra`` as (chain, draw)
        # pairs (post-tune draw numbering, like the reference's
        # ``step`` field after the tune offset).
        ch_idx, dr_idx = np.nonzero(diverging)
        cap = 1000  # a funnel at 10k chains can diverge >10^4 times
        extra = {
            "divergence_indices": list(zip(ch_idx[:cap].tolist(),
                                           dr_idx[:cap].tolist())),
            "n_divergences": n_divs,
            "divergence_indices_truncated": bool(n_divs > cap),
        }
        warns.append(SamplerWarning(WarningType.DIVERGENCES, message, "error",
                                    None, None, extra))

    if max_treedepth is not None and "reached_max_treedepth" in stats:
        hit = np.asarray(stats["reached_max_treedepth"])
        if hit.size > 0 and hit.mean() > 0.05:
            msg = (
                "The chain reached the maximum tree depth. Increase "
                "max_treedepth, increase target_accept or reparameterize."
            )
            warns.append(SamplerWarning(WarningType.TREEDEPTH, msg, "warn", None, None, None))

    accept_key = "mean_tree_accept" if "mean_tree_accept" in stats else "accept"
    if accept_key in stats:
        accept = np.asarray(stats[accept_key], dtype=np.float64).ravel()
        if accept.size:
            mean_accept = float(accept.mean())
            n_bound = min(100, accept.size)
            lower, upper = _beta_interval_95(
                mean_accept * n_bound, (1.0 - mean_accept) * n_bound
            )
            if target_accept < lower or target_accept > upper:
                msg = (
                    "The acceptance probability does not match the target. It "
                    "is %s, but should be close to %s. Try to increase the "
                    "number of tuning steps." % (mean_accept, target_accept)
                )
                info = {"target": target_accept, "actual": mean_accept}
                warns.append(
                    SamplerWarning(WarningType.BAD_ACCEPTANCE, msg, "warn", None, None, info)
                )

    if "energy" in stats:
        from .utils.diagnostics import bfmi

        energy = np.asarray(stats["energy"], np.float64)
        if energy.shape[-1] >= 4:
            fractions = bfmi(energy)
            if np.nanmin(fractions) < 0.2:
                msg = (
                    "The energy transitions are inefficient (BFMI = %.3f < 0.2). "
                    "The posterior likely has heavy tails; reparameterize."
                    % float(np.nanmin(fractions))
                )
                warns.append(
                    SamplerWarning(WarningType.BAD_ENERGY, msg, "warn", None, None,
                                   {"bfmi": fractions})
                )

    if trace is not None:
        from .utils.diagnostics import split_rhat

        trace = np.asarray(trace)
        if trace.shape[0] >= 2 and trace.shape[1] >= 4:
            rhats = np.array(
                [split_rhat(trace[:, :, i]) for i in range(trace.shape[2])]
            )
            worst = float(np.nanmax(rhats))
            if worst > 1.05:
                msg = (
                    "The rank-normalized split R-hat statistic is larger than "
                    "1.05 for some parameters (max %.3f). The chains likely "
                    "have not mixed; run longer or reparameterize." % worst
                )
                warns.append(
                    SamplerWarning(WarningType.CONVERGENCE, msg, "warn", None, None,
                                   {"rhat": rhats})
                )

    return warns
