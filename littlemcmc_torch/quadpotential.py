"""Diagonal quadpotentials (mass matrices), batched over chains.

Counterpart of the diagonal part of ``littlemcmc_tpu/quadpotential.py``:
``WelfordVariance`` (``:89-135``), ``QuadPotentialDiag`` (``:189-221``)
and ``QuadPotentialDiagAdapt`` (``:302-411``, dual-window Welford with a
swap every ``adaptation_window`` samples). Where the JAX package vmaps a
per-chain pytree, these classes hold ``(C, n)`` tensors (``(C,)`` for
per-chain scalars) and update every chain at once. The same code also
serves one chain with ``(n,)`` tensors and 0-d scalars. ``update``
returns a new object.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["WelfordVariance", "QuadPotentialDiag", "QuadPotentialDiagAdapt"]


def _leaves(obj) -> list:
    """A dataclass's fields in order (no copies, unlike ``astuple``)."""
    return [getattr(obj, f.name) for f in dataclasses.fields(obj)]


def _rows(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-chain scalar as a column that broadcasts against ``like``."""
    return x[..., None] if x.ndim < like.ndim else x


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
