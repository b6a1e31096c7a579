"""Quadpotentials (mass matrices), batched over chains.

Counterpart of the diagonal and dense parts of
``littlemcmc_tpu/quadpotential.py``: ``PositiveDefiniteError`` and
``partial_check_positive_definite`` (``:54-79``), ``WelfordVariance``
(``:89-135``), ``WelfordCovariance`` (``:138-180``), ``QuadPotentialDiag``
(``:189-221``), ``QuadPotentialFull`` (``:224-258``),
``QuadPotentialDiagAdapt`` (``:302-411``, dual-window Welford with a swap
every ``adaptation_window`` samples), ``QuadPotentialFullInv``
(``:262-293``, a static dense metric given by the mass matrix itself),
``QuadPotentialFullAdapt``
(``:415-541``, Stan windows, shrinkage and a latched Cholesky failure),
the low-rank metric ``QuadPotentialLowRankAdapt`` with its helpers
``_orthonormal_columns`` and ``_effective_eigenvalues`` (``:544-843``),
the ``quad_potential`` factory (``:845-863``) and ``isquadpotential``
(``:866``). Where the JAX package
vmaps a per-chain pytree, these classes hold ``(C, n)`` tensors (``(C,)``
for per-chain scalars, ``(C, n, n)`` for dense matrices) and update every
chain at once. The same code also serves one chain with ``(n,)`` tensors
and 0-d scalars. ``update`` returns a new object. A broadcast dense matrix
is an ``expand``-ed view, not a copy: every update is out of place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .math import fp32_matmul
from .streams import randn

__all__ = ["PositiveDefiniteError", "partial_check_positive_definite", "quad_potential",
           "potential_to",
           "WelfordVariance", "WelfordCovariance", "QuadPotentialDiag",
           "QuadPotentialDiagAdapt", "QuadPotentialFull", "QuadPotentialFullAdapt",
           "QuadPotentialFullInv", "QuadPotentialLowRankAdapt", "isquadpotential"]


class PositiveDefiniteError(ValueError):
    """Raised when a scaling matrix fails the simple PD check."""

    def __init__(self, msg, idx):
        super().__init__(msg)
        self.idx = idx
        self.msg = msg

    def __str__(self):
        return "Scaling is not positive definite: %s. Check indexes %s." % (
            self.msg, self.idx)


def partial_check_positive_definite(C) -> None:
    """Simple partial PD check on the diagonal (reference ``quadpotential.py:68-77``)."""
    C = np.asarray(C.detach().cpu() if isinstance(C, torch.Tensor) else C)
    d = C if C.ndim == 1 else np.diag(C)
    (i,) = np.nonzero(np.logical_or(np.isnan(d), d <= 0))
    if len(i):
        raise PositiveDefiniteError("Simple check failed. Diagonal contains negatives", i)


def _leaves(obj) -> list:
    """A dataclass's fields in order (no copies, unlike ``astuple``)."""
    return [getattr(obj, f.name) for f in dataclasses.fields(obj)]


def potential_to(potential, device, dtype=None):
    """A metric with every tensor moved to ``device`` (and every floating
    tensor cast to ``dtype``, where given)."""
    def move(x):
        if isinstance(x, torch.Tensor):
            if dtype is not None and x.is_floating_point():
                return x.to(device, dtype)
            return x.to(device)
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{f.name: move(getattr(x, f.name))
                                             for f in dataclasses.fields(x)})
        return x

    return move(potential)


def _rows(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-chain scalar as a column that broadcasts against ``like``."""
    return x[..., None] if x.ndim < like.ndim else x


def _mats(x: torch.Tensor) -> torch.Tensor:
    """A per-chain scalar that broadcasts against per-chain matrices."""
    return x[..., None, None]


def _outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched outer product ``a b^T`` over the last axis."""
    return a[..., :, None] * b[..., None, :]


def _matvec(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``m @ p`` per chain: ``(..., n, n)`` by ``(..., n)``, in full fp32."""
    return fp32_matmul(m, p[..., None])[..., 0]


def cholesky_or_keep(cov: torch.Tensor, old_chol: torch.Tensor):
    """``(chol, ok)``: the lower Cholesky factor of ``cov`` where it exists
    and is finite (``ok``, per matrix), else ``old_chol``. ``cholesky_ex``
    reports failure in ``info`` without a host sync."""
    chol, info = torch.linalg.cholesky_ex(cov)
    ok = (info == 0) & torch.isfinite(chol).all(-1).all(-1)
    return torch.where(_mats(ok), chol, old_chol), ok


@dataclasses.dataclass(frozen=True)
class WelfordVariance:
    """Online weighted mean and variance (reference ``quadpotential.py:294-343``)."""

    w_sum: torch.Tensor
    w_sum2: torch.Tensor
    mean: torch.Tensor
    raw_var: torch.Tensor

    @classmethod
    def create(cls, mean: torch.Tensor, variance: torch.Tensor | None = None,
               weight: float = 0.0) -> "WelfordVariance":
        """Start at ``mean`` (``(..., n)``) with ``variance`` at ``weight``."""
        w = torch.full(mean.shape[:-1], weight, dtype=mean.dtype, device=mean.device)
        var = torch.zeros_like(mean) if variance is None else variance
        return cls(w_sum=w, w_sum2=w * w, mean=mean, raw_var=var * weight)

    def add_sample(self, x: torch.Tensor, weight: float = 1.0) -> "WelfordVariance":
        """One Welford update (reference ``quadpotential.py:324-332``)."""
        w_sum = self.w_sum + weight
        prop = weight / w_sum
        old_diff = x - self.mean
        mean = self.mean + _rows(prop, x) * old_diff
        new_diff = x - mean
        return WelfordVariance(w_sum=w_sum, w_sum2=self.w_sum2 + weight * weight,
                               mean=mean, raw_var=self.raw_var + weight * old_diff * new_diff)

    def current_variance(self) -> torch.Tensor:
        """Biased (divide-by-``w_sum``) variance, the metric's diagonal."""
        return self.raw_var / _rows(self.w_sum, self.raw_var)


@dataclasses.dataclass(frozen=True)
class WelfordCovariance:
    """Online mean and covariance, Stan-math style (reference
    ``quadpotential.py:563-615``). ``n_samples`` counts the initial weight."""

    n_samples: torch.Tensor
    mean: torch.Tensor
    raw_cov: torch.Tensor

    @classmethod
    def create(cls, mean: torch.Tensor, covariance: torch.Tensor | None = None,
               weight: float = 0.0) -> "WelfordCovariance":
        """Start at ``mean`` (``(..., n)``) with ``covariance`` (``(n, n)``
        or ``(..., n, n)``, default the identity) at ``weight``."""
        n = mean.shape[-1]
        w = torch.full(mean.shape[:-1], weight, dtype=mean.dtype, device=mean.device)
        if covariance is None:
            covariance = torch.eye(n, dtype=mean.dtype, device=mean.device)
        raw = (covariance * weight).expand(*mean.shape[:-1], n, n)
        return cls(n_samples=w, mean=mean, raw_cov=raw)

    def add_sample(self, x: torch.Tensor, weight: float = 1.0) -> "WelfordCovariance":
        """One update; the count always moves by 1 (reference ``:598-604``)."""
        n = self.n_samples + 1.0
        old_diff = x - self.mean
        mean = self.mean + old_diff / _rows(n, x)
        new_diff = x - mean
        return WelfordCovariance(n_samples=n, mean=mean,
                                 raw_cov=self.raw_cov + weight * _outer(new_diff, old_diff))

    def current_covariance(self) -> torch.Tensor:
        """Unbiased (divide-by-``n-1``) covariance (reference ``:606-612``)."""
        return self.raw_cov / _mats(self.n_samples - 1.0)


@dataclasses.dataclass(frozen=True)
class QuadPotentialDiag:
    """Fixed diagonal metric; ``v`` is the inverse-mass diagonal."""

    v: torch.Tensor
    s: torch.Tensor
    inv_s: torch.Tensor

    @classmethod
    def create(cls, v: torch.Tensor) -> "QuadPotentialDiag":
        s = torch.sqrt(v)
        return cls(v=v, s=s, inv_s=1.0 / s)

    @property
    def inverse_mass(self) -> torch.Tensor:
        return self.v

    def velocity(self, p: torch.Tensor) -> torch.Tensor:
        return self.v * p

    def kinetic(self, p: torch.Tensor, velocity: torch.Tensor | None = None) -> torch.Tensor:
        if velocity is None:
            velocity = self.velocity(p)
        return 0.5 * (p * velocity).sum(-1)

    def sample_momentum(self, generator: torch.Generator | None = None) -> torch.Tensor:
        z = randn(self.s.shape, generator, self.s.dtype, self.s.device)
        return z * self.inv_s

    def update(self, sample, grad, tuning: bool) -> "QuadPotentialDiag":
        return self

    def broadcast(self, chains: int) -> "QuadPotentialDiag":
        """One chain's metric repeated for ``chains`` chains."""
        return QuadPotentialDiag(*(x.expand(chains, *x.shape).clone()
                                   for x in (self.v, self.s, self.inv_s)))

    def raise_ok(self) -> None:
        return None


class _DenseKinetics:
    """Velocity, kinetic energy and momentum of a dense metric held as a
    covariance ``cov`` (the inverse mass) and its lower factor ``chol``."""

    @property
    def inverse_mass(self) -> torch.Tensor:
        return self.cov

    def velocity(self, p: torch.Tensor) -> torch.Tensor:
        return _matvec(self.cov, p)

    def kinetic(self, p: torch.Tensor, velocity: torch.Tensor | None = None) -> torch.Tensor:
        if velocity is None:
            velocity = self.velocity(p)
        return 0.5 * (p * velocity).sum(-1)

    def sample_momentum(self, generator: torch.Generator | None = None) -> torch.Tensor:
        """``p = L^{-T} z``, so that ``p ~ N(0, cov^{-1})``."""
        z = randn(self.cov.shape[:-1], generator, self.cov.dtype, self.cov.device)
        return torch.linalg.solve_triangular(self.chol.mT, z[..., None], upper=True)[..., 0]


@dataclasses.dataclass(frozen=True)
class QuadPotentialFull(_DenseKinetics):
    """Fixed dense metric parameterized by a covariance (the inverse mass),
    ``velocity = cov @ p`` (reference ``quadpotential.py:430-468``)."""

    cov: torch.Tensor
    chol: torch.Tensor  # lower Cholesky factor of cov

    @classmethod
    def create(cls, cov: torch.Tensor) -> "QuadPotentialFull":
        return cls(cov=cov, chol=torch.linalg.cholesky(cov))

    def update(self, sample, grad, tuning: bool) -> "QuadPotentialFull":
        return self

    def broadcast(self, chains: int) -> "QuadPotentialFull":
        """One chain's metric shared by ``chains`` chains (views, no copies)."""
        return QuadPotentialFull(*(x.expand(chains, *x.shape) for x in (self.cov, self.chol)))

    def raise_ok(self) -> None:
        return None


@dataclasses.dataclass(frozen=True)
class QuadPotentialFullInv:
    """Fixed dense metric parameterized by the mass (precision) matrix
    ``A`` itself: ``velocity = A^{-1} p`` by Cholesky solves, momentum
    ``p = L z`` (reference ``quadpotential.py:262-293``). No kernel takes
    it: NUTS runs it on the tensor-op tree, HMC on its tensor-op
    trajectory."""

    chol: torch.Tensor  # lower Cholesky factor of the mass matrix

    @classmethod
    def create(cls, A: torch.Tensor) -> "QuadPotentialFullInv":
        return cls(chol=torch.linalg.cholesky(A))

    def velocity(self, p: torch.Tensor) -> torch.Tensor:
        return torch.cholesky_solve(p[..., None], self.chol)[..., 0]

    def kinetic(self, p: torch.Tensor, velocity: torch.Tensor | None = None) -> torch.Tensor:
        if velocity is None:
            velocity = self.velocity(p)
        return 0.5 * (p * velocity).sum(-1)

    def sample_momentum(self, generator: torch.Generator | None = None) -> torch.Tensor:
        z = randn(self.chol.shape[:-1], generator, self.chol.dtype, self.chol.device)
        return _matvec(self.chol, z)

    def update(self, sample, grad, tuning: bool) -> "QuadPotentialFullInv":
        return self

    def broadcast(self, chains: int) -> "QuadPotentialFullInv":
        """One chain's metric shared by ``chains`` chains (a view)."""
        return QuadPotentialFullInv(chol=self.chol.expand(chains, *self.chol.shape))

    def raise_ok(self) -> None:
        return None


class _DiagWelfordLeaves:
    """The per-chain diag Welford state of an adaptive metric (``var``,
    ``stds``, ``inv_stds``, ``fg``, ``bg``, ``n_samples``, ``window``) as the
    fused kernels take and return it."""

    def welford_leaves(self) -> tuple:
        """The Welford state as the fused kernels take it (the order of
        ``ops.fused_nuts.WELFORD_KEYS``): the windows' means and raw
        variances ``(C, n)``, their weights, and the counters as float32
        ``(C,)``."""
        f32 = torch.float32
        return (self.fg.mean, self.fg.raw_var, self.fg.w_sum, self.fg.w_sum2,
                self.bg.mean, self.bg.raw_var, self.bg.w_sum, self.bg.w_sum2,
                self.n_samples.to(f32), self.window.to(f32))

    def with_welford_leaves(self, var: torch.Tensor, leaves):
        """This metric with the inverse-mass diagonal ``var`` and the Welford
        state ``leaves`` of :meth:`welford_leaves`' layout (a fused kernel's
        outputs); its other fields as they were."""
        fgm, fgr, fgw, fgw2, bgm, bgr, bgw, bgw2, ns, win = leaves
        stds = torch.sqrt(var)
        return dataclasses.replace(
            self, var=var, stds=stds, inv_stds=1.0 / stds,
            fg=WelfordVariance(w_sum=fgw, w_sum2=fgw2, mean=fgm, raw_var=fgr),
            bg=WelfordVariance(w_sum=bgw, w_sum2=bgw2, mean=bgm, raw_var=bgr),
            n_samples=ns.to(torch.int32), window=win.to(torch.int32))

    def _diag_step(self, sample: torch.Tensor):
        """The diag adaptation's step (reference ``quadpotential.py:
        231-245``): ``(fields, fg, swap)``, the new diag fields, the
        foreground after the add and before the swap, and where the windows
        swapped."""
        fg = self.fg.add_sample(sample)
        bg = self.bg.add_sample(sample)
        var = fg.current_variance()
        stds = torch.sqrt(var)
        swap = (self.n_samples > 0) & (torch.remainder(self.n_samples, self.window) == 0)
        fresh = WelfordVariance.create(torch.zeros_like(sample))

        def pick(a, b):
            return WelfordVariance(*(torch.where(_rows(swap, x), x, y) for x, y in
                                     zip(_leaves(a), _leaves(b))))

        window = torch.where(
            swap, (self.window.to(torch.float32) * self.window_multiplier).to(torch.int32),
            self.window)
        fields = dict(var=var, stds=stds, inv_stds=1.0 / stds, fg=pick(bg, fg),
                      bg=pick(fresh, bg), n_samples=self.n_samples + 1, window=window)
        return fields, fg, swap

    def _raise_diag_ok(self) -> None:
        """Host-side check mirroring reference ``quadpotential.py:247-291``."""
        stds = self.stds.detach().cpu().numpy().reshape(-1, self.stds.shape[-1])
        for what, bad in (("zeros", stds == 0), ("non-finite values", ~np.isfinite(stds))):
            index = np.nonzero(bad.any(axis=0))[0]
            if index.size:
                raise ValueError(
                    f"Mass matrix contains {what} on the diagonal.\n"
                    + "\n".join(f"The derivative of RV ravel()[{i}] is "
                                f"{'zero' if what == 'zeros' else 'non-finite'}."
                                for i in index))


@dataclasses.dataclass(frozen=True)
class QuadPotentialDiagAdapt(_DiagWelfordLeaves):
    """Diagonal metric adapted from sample variances with two Welford windows.

    Order of one update (reference ``quadpotential.py:231-245``): add the
    sample to both windows, refresh the metric from the foreground, then
    swap the windows when ``n_samples % window == 0``.
    """

    var: torch.Tensor  # inverse-mass diagonal (the sample variance)
    stds: torch.Tensor
    inv_stds: torch.Tensor
    fg: WelfordVariance
    bg: WelfordVariance
    n_samples: torch.Tensor  # int32 per chain
    window: torch.Tensor  # int32 per chain
    window_multiplier: float = 1.0

    @classmethod
    def create(cls, initial_mean: torch.Tensor, initial_diag: torch.Tensor | None = None,
               initial_weight: float = 0.0, adaptation_window: int = 101,
               adaptation_window_multiplier: float = 1.0) -> "QuadPotentialDiagAdapt":
        """Metric over ``initial_mean``'s shape: ``(n,)`` or ``(C, n)``."""
        if initial_diag is None:
            # reference default: identity with weight 1 (quadpotential.py:178-180)
            initial_diag = torch.ones_like(initial_mean)
            initial_weight = 1.0
        stds = torch.sqrt(initial_diag)
        lead = initial_mean.shape[:-1]
        dev = initial_mean.device
        return cls(
            var=initial_diag,
            stds=stds,
            inv_stds=1.0 / stds,
            fg=WelfordVariance.create(initial_mean, initial_diag, initial_weight),
            bg=WelfordVariance.create(torch.zeros_like(initial_mean)),
            n_samples=torch.zeros(lead, dtype=torch.int32, device=dev),
            window=torch.full(lead, adaptation_window, dtype=torch.int32, device=dev),
            window_multiplier=float(adaptation_window_multiplier),
        )

    @property
    def inverse_mass(self) -> torch.Tensor:
        return self.var

    def velocity(self, p: torch.Tensor) -> torch.Tensor:
        return self.var * p

    def kinetic(self, p: torch.Tensor, velocity: torch.Tensor | None = None) -> torch.Tensor:
        if velocity is None:
            velocity = self.velocity(p)
        return 0.5 * (p * velocity).sum(-1)

    def sample_momentum(self, generator: torch.Generator | None = None) -> torch.Tensor:
        z = randn(self.stds.shape, generator, self.stds.dtype, self.stds.device)
        return self.inv_stds * z

    def update(self, sample: torch.Tensor, grad: torch.Tensor,
               tuning: bool) -> "QuadPotentialDiagAdapt":
        """One adaptation step; a no-op outside tuning."""
        if not tuning:
            return self
        return dataclasses.replace(self, **self._diag_step(sample)[0])

    def broadcast(self, chains: int) -> "QuadPotentialDiagAdapt":
        """One chain's metric repeated for ``chains`` chains."""
        def rep(x):
            return x.expand(chains, *x.shape).clone()

        return QuadPotentialDiagAdapt(
            var=rep(self.var), stds=rep(self.stds), inv_stds=rep(self.inv_stds),
            fg=WelfordVariance(*map(rep, _leaves(self.fg))),
            bg=WelfordVariance(*map(rep, _leaves(self.bg))),
            n_samples=rep(self.n_samples), window=rep(self.window),
            window_multiplier=self.window_multiplier)

    def raise_ok(self) -> None:
        self._raise_diag_ok()


@dataclasses.dataclass(frozen=True)
class QuadPotentialFullAdapt(_DenseKinetics):
    """Dense metric adapted from sample covariances (Stan style).

    One update (reference ``quadpotential.py:528-555``): add the sample to
    both windows; every ``update_window`` steps refresh ``cov`` from the
    foreground (with Stan's shrinkage toward ``1e-3 I`` when
    ``regularize``) and its Cholesky factor, keeping the old factor and
    latching ``chol_failed`` where the factorization fails; swap the
    windows once ``n_samples - prev_update`` reaches ``window``, which then
    grows by ``window_multiplier``.
    """

    cov: torch.Tensor
    chol: torch.Tensor
    chol_failed: torch.Tensor  # bool per chain
    fg: WelfordCovariance
    bg: WelfordCovariance
    n_samples: torch.Tensor  # int32 per chain
    prev_update: torch.Tensor  # int32 per chain
    window: torch.Tensor  # int32 per chain
    window_multiplier: float = 2.0
    update_window: int = 1
    regularize: bool = True

    @classmethod
    def create(cls, initial_mean: torch.Tensor, initial_cov: torch.Tensor | None = None,
               initial_weight: float = 0.0, adaptation_window: int = 101,
               adaptation_window_multiplier: float = 2.0, update_window: int = 1,
               regularize: bool = True) -> "QuadPotentialFullAdapt":
        """Metric over ``initial_mean``'s shape: ``(n,)`` or ``(C, n)``; an
        ``(n, n)`` ``initial_cov`` is shared by every chain."""
        n = initial_mean.shape[-1]
        lead = initial_mean.shape[:-1]
        dev, dt = initial_mean.device, initial_mean.dtype
        if initial_cov is None:
            initial_cov = torch.eye(n, dtype=dt, device=dev)
            initial_weight = 1.0
        chol = torch.linalg.cholesky(initial_cov)
        return cls(
            cov=initial_cov.expand(*lead, n, n),
            chol=chol.expand(*lead, n, n),
            chol_failed=torch.zeros(lead, dtype=torch.bool, device=dev),
            fg=WelfordCovariance.create(initial_mean, initial_cov, initial_weight),
            bg=WelfordCovariance.create(torch.zeros_like(initial_mean),
                                        torch.zeros_like(initial_cov)),
            n_samples=torch.zeros(lead, dtype=torch.int32, device=dev),
            prev_update=torch.zeros(lead, dtype=torch.int32, device=dev),
            window=torch.full(lead, adaptation_window, dtype=torch.int32, device=dev),
            window_multiplier=float(adaptation_window_multiplier),
            update_window=int(update_window), regularize=bool(regularize),
        )

    def replace(self, **changes) -> "QuadPotentialFullAdapt":
        return dataclasses.replace(self, **changes)

    def update(self, sample: torch.Tensor, grad: torch.Tensor,
               tuning: bool) -> "QuadPotentialFullAdapt":
        """One adaptation step; a no-op outside tuning."""
        if not tuning:
            return self
        delta = self.n_samples - self.prev_update
        fg = self.fg.add_sample(sample)
        bg = self.bg.add_sample(sample)

        do_refresh = torch.remainder(delta + 1, self.update_window) == 0
        cov_new = fg.current_covariance()
        if self.regularize:
            # Stan's shrinkage toward a small diagonal (covar_adaptation):
            # cov <- w/(w+5) cov + 1e-3 * 5/(w+5) I with w draws in the window
            w = fg.n_samples
            shrink = w / (w + 5.0)
            eye = torch.eye(cov_new.shape[-1], dtype=cov_new.dtype, device=cov_new.device)
            cov_new = _mats(shrink) * cov_new + _mats(1e-3 * (1.0 - shrink)) * eye
        chol_new, ok = cholesky_or_keep(cov_new, self.chol)
        cov = torch.where(_mats(do_refresh), cov_new, self.cov)
        chol = torch.where(_mats(do_refresh), chol_new, self.chol)
        chol_failed = self.chol_failed | (do_refresh & ~ok)

        swap = delta >= self.window
        fresh = WelfordCovariance(n_samples=torch.zeros_like(fg.n_samples),
                                  mean=torch.zeros_like(fg.mean),
                                  raw_cov=torch.zeros_like(fg.raw_cov))

        def pick(a, b):
            return WelfordCovariance(
                n_samples=torch.where(swap, a.n_samples, b.n_samples),
                mean=torch.where(_rows(swap, a.mean), a.mean, b.mean),
                raw_cov=torch.where(_mats(swap), a.raw_cov, b.raw_cov))

        return self.replace(
            cov=cov, chol=chol, chol_failed=chol_failed,
            fg=pick(bg, fg), bg=pick(fresh, bg),
            n_samples=self.n_samples + 1,
            prev_update=torch.where(swap, self.n_samples, self.prev_update),
            window=torch.where(
                swap, (self.window.to(torch.float32) * self.window_multiplier).to(torch.int32),
                self.window),
        )

    def broadcast(self, chains: int) -> "QuadPotentialFullAdapt":
        """One chain's metric repeated for ``chains`` chains (views)."""
        def rep(x):
            return x.expand(chains, *x.shape)

        return self.replace(
            cov=rep(self.cov), chol=rep(self.chol), chol_failed=rep(self.chol_failed),
            fg=WelfordCovariance(*map(rep, _leaves(self.fg))),
            bg=WelfordCovariance(*map(rep, _leaves(self.bg))),
            n_samples=rep(self.n_samples), prev_update=rep(self.prev_update),
            window=rep(self.window))

    def raise_ok(self) -> None:
        if bool(self.chol_failed.any()):
            raise ValueError("Cholesky factorization of the adapted mass matrix failed.")


def _orthonormal_columns(A: torch.Tensor) -> torch.Tensor:
    """The columns of ``A`` (``(..., n, k)``) orthonormalized by CholeskyQR
    with the positive-R sign (reference ``quadpotential.py:544-566``):
    ``A L^{-T}`` with ``L = chol(AᵀA + eps I)``, ``eps = 1e-6 (tr(AᵀA)/k +
    1)``. The sign convention lets the cross-chain pool average per-chain
    bases without cancellation; ``cholesky_ex`` keeps the host out."""
    G = fp32_matmul(A.mT, A)
    k = G.shape[-1]
    eps = 1e-6 * (torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) / k + 1.0)
    eye = torch.eye(k, dtype=G.dtype, device=G.device)
    L = torch.linalg.cholesky_ex(G + _mats(eps) * eye)[0]
    return torch.linalg.solve_triangular(L, A.mT, upper=False).mT


def _effective_eigenvalues(s2: torch.Tensor, w: torch.Tensor, clip: float) -> torch.Tensor:
    """Second moments ``s2`` at weight ``w`` (broadcast against ``s2``)
    shrunk toward 1 with a pseudo-count of 5, then clipped to ``[1/clip,
    clip]`` (reference ``quadpotential.py:569-582``)."""
    raw = s2 / torch.clamp(w, min=1.0)
    shrunk = (w * raw + 5.0) / (w + 5.0)
    return torch.clamp(shrunk, 1.0 / clip, clip)


def _lowrank_start_basis(n: int, k: int) -> np.ndarray:
    """The deterministic orthonormal start basis ``(n, k)`` of
    ``QuadPotentialLowRankAdapt.create`` (reference ``:681-683``): the
    same numpy calls, so the same bits as the JAX package's."""
    return np.linalg.qr(np.random.RandomState(20240817).standard_normal((n, k)))[0].astype(
        np.float32)


@dataclasses.dataclass(frozen=True)
class QuadPotentialLowRankAdapt(_DiagWelfordLeaves):
    """Spiked adaptive metric ``Σ̂ = S (α(I−VVᵀ) + VΛVᵀ) S`` (reference
    ``quadpotential.py:585-843``), batched over chains.

    The diagonal ``S² = var`` follows :class:`QuadPotentialDiagAdapt`
    exactly. ``vecs`` ``(..., n, k)`` spans the standardized directions
    whose variance ``lam`` departs most from 1 and ``alpha`` rescales the
    bulk; every metric operation is ``O(nk)``:
    ``velocity(p) = S C (S p)`` and momentum ``p = S⁻¹ C^{-1/2} ζ`` with
    ``C^s x = α^s x + V((λ^s − α^s)·(Vᵀx))``. Per chain, each tuning draw
    takes one shifted subspace-iteration step ``V ← orth(V + Zᵀ(ZV)/m)``
    against a ring buffer of the last ``buffer_size`` positions (inert
    until ``buf_fill`` says the buffer is full) and scores the new sample
    on the previous basis for the eigenvalue accumulators, which decay by
    half at each window swap. Under cross-chain pooling
    (:mod:`littlemcmc_torch.parallel.cross_chain`) the basis is refreshed
    from the cross-chain batch instead.
    """

    var: torch.Tensor  # (..., n) inverse-mass diagonal (the sample variance)
    stds: torch.Tensor
    inv_stds: torch.Tensor
    fg: WelfordVariance
    bg: WelfordVariance
    n_samples: torch.Tensor  # int32 per chain
    window: torch.Tensor  # int32 per chain
    vecs: torch.Tensor  # (..., n, k) orthonormal columns
    lam: torch.Tensor  # (..., k) effective eigenvalues
    alpha: torch.Tensor  # (...,) effective residual-bulk variance
    lam_w: torch.Tensor  # (...,) second-moment weight
    lam_s2: torch.Tensor  # (..., k) raw sums of squared projections
    alpha_s2: torch.Tensor  # (...,) raw sum of residual squared norms
    buf: torch.Tensor  # (..., m, n) ring buffer of recent positions
    buf_pos: torch.Tensor  # int32 per chain, next write slot
    buf_fill: torch.Tensor  # int32 per chain, valid rows (saturates at m)
    window_multiplier: float = 1.0
    rank: int = 8
    lam_clip: float = 100.0
    buffer_size: int = 32

    @classmethod
    def create(cls, initial_mean: torch.Tensor, initial_diag: torch.Tensor | None = None,
               initial_weight: float = 0.0, adaptation_window: int = 101,
               adaptation_window_multiplier: float = 1.0, rank: int = 8,
               lam_clip: float = 100.0, buffer_size: int = 32) -> "QuadPotentialLowRankAdapt":
        """Metric over ``initial_mean``'s shape: ``(n,)`` or ``(C, n)``."""
        diag = QuadPotentialDiagAdapt.create(initial_mean, initial_diag, initial_weight,
                                             adaptation_window, adaptation_window_multiplier)
        n = initial_mean.shape[-1]
        lead = initial_mean.shape[:-1]
        dev, dt = initial_mean.device, initial_mean.dtype
        k = max(1, min(int(rank), n))
        v0 = torch.from_numpy(_lowrank_start_basis(n, k)).to(device=dev, dtype=dt)

        def zeros(*shape, dtype=dt):
            return torch.zeros((*lead, *shape), dtype=dtype, device=dev)

        return cls(
            var=diag.var, stds=diag.stds, inv_stds=diag.inv_stds, fg=diag.fg, bg=diag.bg,
            n_samples=diag.n_samples, window=diag.window,
            vecs=v0.expand(*lead, n, k).clone(), lam=zeros(k) + 1.0, alpha=zeros() + 1.0,
            lam_w=zeros(), lam_s2=zeros(k), alpha_s2=zeros(),
            buf=zeros(int(buffer_size), n), buf_pos=zeros(dtype=torch.int32),
            buf_fill=zeros(dtype=torch.int32),
            window_multiplier=float(adaptation_window_multiplier), rank=k,
            lam_clip=float(lam_clip), buffer_size=int(buffer_size))

    def replace(self, **changes) -> "QuadPotentialLowRankAdapt":
        return dataclasses.replace(self, **changes)

    @property
    def inverse_mass(self) -> torch.Tensor:
        return self.var

    def _corr_matvec(self, x: torch.Tensor, power: float) -> torch.Tensor:
        """``C^s x = α^s x + V((λ^s − α^s)·(Vᵀx))`` per chain."""
        a = self.alpha ** power
        c = fp32_matmul(x[..., None, :], self.vecs)[..., 0, :]
        return (_rows(a, x) * x
                + fp32_matmul(self.vecs, ((self.lam ** power - a[..., None]) * c)[..., None])
                [..., 0])

    def velocity(self, p: torch.Tensor) -> torch.Tensor:
        return self.stds * self._corr_matvec(self.stds * p, 1.0)

    def kinetic(self, p: torch.Tensor, velocity: torch.Tensor | None = None) -> torch.Tensor:
        if velocity is None:
            velocity = self.velocity(p)
        return 0.5 * (p * velocity).sum(-1)

    def sample_momentum(self, generator: torch.Generator | None = None) -> torch.Tensor:
        """``p = S⁻¹ C^{-1/2} ζ``, so that ``cov(p) = Σ̂⁻¹``."""
        zeta = randn(self.stds.shape, generator, self.stds.dtype, self.stds.device)
        return self.inv_stds * self._corr_matvec(zeta, -0.5)

    def update(self, sample: torch.Tensor, grad: torch.Tensor,
               tuning: bool) -> "QuadPotentialLowRankAdapt":
        """One adaptation step (reference ``quadpotential.py:722-820``); a
        no-op outside tuning."""
        if not tuning:
            return self
        diag, fg, swap = self._diag_step(sample)  # fg: the pre-swap foreground
        inv_stds = diag["inv_stds"]

        m = self.buffer_size
        slot = torch.arange(m, device=sample.device) == self.buf_pos[..., None]
        buf = torch.where(slot[..., None], sample[..., None, :], self.buf)
        buf_pos = torch.remainder(self.buf_pos + 1, m)
        # buf_fill (not n_samples) gates readiness: a fused chunk leaves
        # n_samples large and the buffer stale, and its epilogue zeroes
        # buf_fill so the buffer refills before it is trusted again
        buf_fill = torch.clamp(self.buf_fill + 1, max=m)
        ready = buf_fill >= m

        Z = (buf - fg.mean[..., None, :]) * inv_stds[..., None, :]  # (..., m, n)
        step = fp32_matmul(Z.mT, fp32_matmul(Z, self.vecs)) / float(m)
        vecs = torch.where(_mats(ready), _orthonormal_columns(self.vecs + step), self.vecs)
        # the new sample on the previous basis: out of sample, so the
        # eigenvalues avoid the selection bias of the draws that chose it
        z = (sample - fg.mean) * inv_stds
        c2 = fp32_matmul(z[..., None, :], self.vecs)[..., 0, :] ** 2
        r2 = torch.clamp((z * z).sum(-1) - c2.sum(-1), min=0.0)
        decay = torch.where(swap, 0.5, 1.0).to(sample.dtype)
        gain = ready.to(sample.dtype)
        lam_w = self.lam_w * decay + gain
        lam_s2 = self.lam_s2 * decay[..., None] + gain[..., None] * c2
        alpha_s2 = self.alpha_s2 * decay + gain * r2
        n_resid = max(self.var.shape[-1] - self.rank, 1)
        return self.replace(
            **diag, vecs=vecs,
            lam=_effective_eigenvalues(lam_s2, lam_w[..., None], self.lam_clip),
            alpha=_effective_eigenvalues(alpha_s2 / n_resid, lam_w, self.lam_clip),
            lam_w=lam_w, lam_s2=lam_s2, alpha_s2=alpha_s2,
            buf=buf, buf_pos=buf_pos, buf_fill=buf_fill)

    def broadcast(self, chains: int) -> "QuadPotentialLowRankAdapt":
        """One chain's metric repeated for ``chains`` chains."""
        def rep(x):
            if isinstance(x, WelfordVariance):
                return WelfordVariance(*map(rep, _leaves(x)))
            return x.expand(chains, *x.shape).clone()

        return self.replace(**{f.name: rep(getattr(self, f.name))
                               for f in dataclasses.fields(self)
                               if not isinstance(getattr(self, f.name), (int, float))})

    def raise_ok(self) -> None:
        """The diagonal's check, then positive finite eigenvalues
        (reference ``quadpotential.py:822-843``)."""
        self._raise_diag_ok()
        lam = self.lam.detach().cpu().numpy()
        alpha = self.alpha.detach().cpu().numpy()
        if (np.any(~np.isfinite(lam)) or np.any(lam <= 0)
                or np.any(~np.isfinite(alpha)) or np.any(alpha <= 0)):
            raise ValueError("Low-rank metric eigenvalues are non-finite or non-positive.")


def quad_potential(C, is_cov: bool):
    """A static metric from a scaling vector or matrix (reference
    ``quadpotential.py:33-65``): a 1-D ``C`` is a diagonal, a 2-D ``C`` a
    dense covariance (``is_cov=True``) or mass matrix (``is_cov=False``,
    :class:`QuadPotentialFullInv`). ``is_cov`` selects covariance vs
    precision."""
    if type(C).__module__.startswith("scipy.sparse"):
        raise ValueError("Sparse scaling matrices are not supported.")
    C = torch.as_tensor(np.asarray(C.detach().cpu() if isinstance(C, torch.Tensor) else C),
                        dtype=torch.float32)
    partial_check_positive_definite(C)
    if C.ndim == 1:
        return QuadPotentialDiag.create(C if is_cov else 1.0 / C)
    if is_cov:
        return QuadPotentialFull.create(C)
    return QuadPotentialFullInv.create(C)


def isquadpotential(value) -> bool:
    """Whether ``value`` is one of this package's metrics (reference
    ``quadpotential.py:866-879``)."""
    return isinstance(value, (QuadPotentialDiag, QuadPotentialFull, QuadPotentialFullInv,
                              QuadPotentialDiagAdapt, QuadPotentialFullAdapt,
                              QuadPotentialLowRankAdapt))
