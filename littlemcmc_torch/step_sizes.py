"""Dual-averaging step-size adaptation, batched over chains.

Counterpart of ``littlemcmc_tpu/step_sizes.py:25-80`` (Nesterov dual
averaging, Hoffman & Gelman Algorithm 5; reference
``step_sizes.py:71-92``). Every leaf is a ``(C,)`` tensor; the update
returns a new state.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["DualAverageState", "dual_average_init", "dual_average_update"]


@dataclasses.dataclass(frozen=True)
class DualAverageState:
    """Per-chain dual-averaging state (reference ``step_sizes.py:49-56``)."""

    log_step: torch.Tensor
    log_bar: torch.Tensor
    hbar: torch.Tensor
    count: torch.Tensor  # int32, starts at 1
    mu: torch.Tensor

    def current(self, adapting: bool) -> torch.Tensor:
        """Step size to use this draw (reference ``step_sizes.py:58-69``)."""
        return torch.exp(self.log_step if adapting else self.log_bar)


def dual_average_init(initial_step: float, chains: int,
                      device=None) -> DualAverageState:
    """``chains`` identical states starting at ``initial_step``."""
    step = torch.full((chains,), initial_step, dtype=torch.float32, device=device)
    log_step = torch.log(step)
    return DualAverageState(
        log_step=log_step,
        log_bar=log_step.clone(),
        hbar=torch.zeros_like(step),
        count=torch.ones(chains, dtype=torch.int32, device=device),
        mu=torch.log(10.0 * step),
    )


def dual_average_update(state: DualAverageState, accept_stat: torch.Tensor,
                        adapting: bool, *, target: float, gamma: float,
                        k: float, t0: float) -> DualAverageState:
    """One update; returns ``state`` unchanged unless ``adapting``.

    ``w = 1/(count+t0)``; ``hbar <- (1-w) hbar + w (target - accept)``;
    ``log_step = mu - hbar sqrt(count)/gamma``;
    ``log_bar <- count^-k log_step + (1 - count^-k) log_bar``.
    """
    if not adapting:
        return state
    count = state.count.to(state.log_step.dtype)
    w = 1.0 / (count + t0)
    hbar = (1.0 - w) * state.hbar + w * (target - accept_stat)
    log_step = state.mu - hbar * torch.sqrt(count) / gamma
    mk = count ** (-k)
    log_bar = mk * log_step + (1.0 - mk) * state.log_bar
    return DualAverageState(log_step=log_step, log_bar=log_bar, hbar=hbar,
                            count=state.count + 1, mu=state.mu)
