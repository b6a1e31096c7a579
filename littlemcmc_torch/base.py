"""Shared HMC machinery: the NUTS and HMC configs and the chain-batched state.

Counterpart of ``littlemcmc_tpu/base.py:27-154``. ``ChainState`` holds
every chain at once: ``(C, n)`` positions and gradients, ``(C,)`` log
densities and counters, and a batched metric and dual-averaging state.
Randomness does not live in the state: the driver owns explicit
``torch.Generator`` objects.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from .integration import IntegratorState, recompute_with_momentum
from .step_sizes import DualAverageState, dual_average_init, dual_average_update

__all__ = ["NUTSConfig", "HMCConfig", "ChainState", "init_chain_state",
           "start_of_trajectory", "finish_step", "pooled_tune_schedule"]

BatchedLogpGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class _BaseConfig:
    """Options both step methods share (defaults from reference ``nuts.py:110-120``)."""

    target_accept: float = 0.8
    Emax: float = 1000.0
    adapt_step_size: bool = True
    step_scale: float = 0.25
    gamma: float = 0.05
    k: float = 0.75
    t0: float = 10.0
    # "leapfrog" (reference parity), "two_stage" or "three_stage"
    integrator: str = "leapfrog"
    # chains per kernel block (0: the step method's default)
    chain_block: int = 0
    # step_rand(step_size (C,), generator) -> (C,): redraws the step sizes
    # before each trajectory on the per-draw engine (reference
    # base_hmc.py:154-155)
    step_rand: object = None


@dataclasses.dataclass(frozen=True)
class NUTSConfig(_BaseConfig):
    """NUTS options (defaults from reference ``nuts.py:103-120``)."""

    max_treedepth: int = 10
    early_max_treedepth: int = 8
    # tuning iterations that use early_max_treedepth (reference nuts.py:205)
    early_window: int = 200


@dataclasses.dataclass(frozen=True)
class HMCConfig(_BaseConfig):
    """Classic HMC options (reference ``hmc.py:52-68``)."""

    path_length: float = 2.0
    max_steps: int = 1024


@dataclasses.dataclass(frozen=True)
class ChainState:
    """Everything the chains carry between draws, batched over chains."""

    q: torch.Tensor  # (C, n)
    q_grad: torch.Tensor  # (C, n)
    logp: torch.Tensor  # (C,)
    potential: object  # a batched quadpotential
    da: DualAverageState
    iter_count: torch.Tensor  # (C,) int32


def init_chain_state(q0: torch.Tensor, potential, config: _BaseConfig,
                     logp_grad_fn: BatchedLogpGrad) -> ChainState:
    """Start every chain at its row of ``q0`` (``(C, n)``), in ``q0``'s dtype.

    The initial step size is ``step_scale / ndim**0.25``
    (reference ``base_hmc.py:102``).
    """
    logp, grad = logp_grad_fn(q0)
    chains, ndim = q0.shape
    return ChainState(
        q=q0, q_grad=grad, logp=logp, potential=potential,
        da=dual_average_init(config.step_scale / (ndim ** 0.25), chains, q0.device,
                             q0.dtype),
        iter_count=torch.zeros(chains, dtype=torch.int32, device=q0.device),
    )


def start_of_trajectory(state: ChainState, generator) -> IntegratorState:
    """Draw a fresh momentum for every chain and assemble the trajectory
    start from the cached ``(logp, grad)``, with no model call (reference
    ``base_hmc.py:142-143``; ``littlemcmc_tpu/base.py:114``). ``generator``:
    a ``torch.Generator`` or a :class:`~littlemcmc_torch.streams.DrawStream`."""
    p0 = state.potential.sample_momentum(generator)
    return recompute_with_momentum(state.potential, state.q, state.q_grad, state.logp, p0)


def finish_step(state: ChainState, proposal_q: torch.Tensor,
                proposal_grad: torch.Tensor, proposal_logp: torch.Tensor,
                accept_stat: torch.Tensor, tuning: bool,
                config: _BaseConfig) -> ChainState:
    """Adaptation updates after one transition (reference ``base_hmc.py:161-162``)."""
    da = dual_average_update(state.da, accept_stat, tuning and config.adapt_step_size,
                             target=config.target_accept, gamma=config.gamma,
                             k=config.k, t0=config.t0)
    return ChainState(
        q=proposal_q, q_grad=proposal_grad, logp=proposal_logp,
        potential=state.potential.update(proposal_q, proposal_grad, tuning),
        da=da, iter_count=state.iter_count + 1,
    )


def pooled_tune_schedule(t: int) -> int:
    """Iterations from tune position ``t`` to the next metric refresh of a
    pooled boundary-cadence metric (reference ``base.py:157-179``).

    The fused pooled dense engine refreshes the shared metric only at
    chunk boundaries, so the chunking is the adaptation schedule:
    boundaries at 10, 20, 50, 100, then every 100, as Stan's expanding
    adaptation windows.
    """
    for b in (10, 20, 50, 100):
        if t < b:
            return b - t
    return 100 - (t % 100)
