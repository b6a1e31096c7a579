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
(``:415-541``, Stan windows, shrinkage and a latched Cholesky failure)
and the ``quad_potential`` factory (``:845-863``). Where the JAX package
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

__all__ = ["PositiveDefiniteError", "partial_check_positive_definite", "quad_potential",
           "potential_to",
           "WelfordVariance", "WelfordCovariance", "QuadPotentialDiag",
           "QuadPotentialDiagAdapt", "QuadPotentialFull", "QuadPotentialFullAdapt",
           "QuadPotentialFullInv"]


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


def potential_to(potential, device):
    """A metric with every tensor moved to ``device``."""
    def move(x):
        if isinstance(x, torch.Tensor):
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
        z = torch.randn(self.s.shape, generator=generator, dtype=self.s.dtype,
                        device=self.s.device)
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
        z = torch.randn(self.cov.shape[:-1], generator=generator, dtype=self.cov.dtype,
                        device=self.cov.device)
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
        z = torch.randn(self.chol.shape[:-1], generator=generator, dtype=self.chol.dtype,
                        device=self.chol.device)
        return _matvec(self.chol, z)

    def update(self, sample, grad, tuning: bool) -> "QuadPotentialFullInv":
        return self

    def broadcast(self, chains: int) -> "QuadPotentialFullInv":
        """One chain's metric shared by ``chains`` chains (a view)."""
        return QuadPotentialFullInv(chol=self.chol.expand(chains, *self.chol.shape))

    def raise_ok(self) -> None:
        return None


@dataclasses.dataclass(frozen=True)
class QuadPotentialDiagAdapt:
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
        z = torch.randn(self.stds.shape, generator=generator, dtype=self.stds.dtype,
                        device=self.stds.device)
        return self.inv_stds * z

    def update(self, sample: torch.Tensor, grad: torch.Tensor,
               tuning: bool) -> "QuadPotentialDiagAdapt":
        """One adaptation step; a no-op outside tuning."""
        if not tuning:
            return self
        fg = self.fg.add_sample(sample)
        bg = self.bg.add_sample(sample)
        var = fg.current_variance()
        stds = torch.sqrt(var)

        swap = (self.n_samples > 0) & (torch.remainder(self.n_samples, self.window) == 0)
        fresh = WelfordVariance.create(torch.zeros_like(sample))

        def pick(a, b):
            return WelfordVariance(*(torch.where(_rows(swap, x), x, y) for x, y in
                                     zip(_leaves(a), _leaves(b))))

        new_window = torch.where(
            swap, (self.window.to(torch.float32) * self.window_multiplier).to(torch.int32),
            self.window)
        return QuadPotentialDiagAdapt(
            var=var, stds=stds, inv_stds=1.0 / stds,
            fg=pick(bg, fg), bg=pick(fresh, bg),
            n_samples=self.n_samples + 1, window=new_window,
            window_multiplier=self.window_multiplier,
        )

    def welford_leaves(self) -> tuple:
        """The Welford state as the fused kernels take it (the order of
        ``ops.fused_nuts.WELFORD_KEYS``): the windows' means and raw
        variances ``(C, n)``, their weights, and the counters as float32
        ``(C,)``."""
        f32 = torch.float32
        return (self.fg.mean, self.fg.raw_var, self.fg.w_sum, self.fg.w_sum2,
                self.bg.mean, self.bg.raw_var, self.bg.w_sum, self.bg.w_sum2,
                self.n_samples.to(f32), self.window.to(f32))

    def with_welford_leaves(self, var: torch.Tensor, leaves) -> "QuadPotentialDiagAdapt":
        """This metric with the inverse mass ``var`` and the Welford state
        ``leaves`` of :meth:`welford_leaves`' layout (a fused kernel's
        outputs)."""
        fgm, fgr, fgw, fgw2, bgm, bgr, bgw, bgw2, ns, win = leaves
        stds = torch.sqrt(var)
        return QuadPotentialDiagAdapt(
            var=var, stds=stds, inv_stds=1.0 / stds,
            fg=WelfordVariance(w_sum=fgw, w_sum2=fgw2, mean=fgm, raw_var=fgr),
            bg=WelfordVariance(w_sum=bgw, w_sum2=bgw2, mean=bgm, raw_var=bgr),
            n_samples=ns.to(torch.int32), window=win.to(torch.int32),
            window_multiplier=self.window_multiplier)

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
