"""The per-draw NUTS transition on the trajectory op, batched over chains.

Counterpart of ``littlemcmc_tpu/nuts.py:682-917`` (``build_nuts_kernel``)
on its trajectory-op path with a diagonal metric: fresh momentum, the
step size from dual averaging, the early tree-depth cap, one trajectory
launch for all chains, then the dual-averaging and metric updates.
``run_nuts_tree`` (the tree built from separate tensor ops, the engine
for models without a kernel body) and the dense and low-rank metrics are
not ported yet.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from .base import ChainState, NUTSConfig, finish_step
from .math import log1mexp
from .ops.nuts_trajectory import DEFAULT_CHAIN_BLOCK, TrajectorySpec, trajectory

__all__ = ["NUTSInfo", "build_nuts_kernel"]


class NUTSInfo(NamedTuple):
    """Per-draw sampler stats, ``(C,)`` each (reference ``nuts.py:87-101``)."""

    depth: torch.Tensor
    step_size: torch.Tensor
    tune: torch.Tensor
    mean_tree_accept: torch.Tensor
    step_size_bar: torch.Tensor
    tree_size: torch.Tensor
    diverging: torch.Tensor
    energy_error: torch.Tensor
    energy: torch.Tensor
    max_energy_error: torch.Tensor
    model_logp: torch.Tensor
    reached_max_treedepth: torch.Tensor


def build_nuts_kernel(config: NUTSConfig = NUTSConfig(),
                      trajectory_spec: Optional[TrajectorySpec] = None
                      ) -> Callable[..., Tuple[ChainState, NUTSInfo]]:
    """``kernel(state, tuning, generator, seed) -> (state, info)``.

    ``generator`` draws the momenta (on the state's device); ``seed`` is
    the trajectory's two int32 counter-stream words for this draw.
    """
    if trajectory_spec is None:
        raise NotImplementedError(
            "littlemcmc_torch runs NUTS only through the trajectory kernel, "
            "which needs a model with a trajectory_spec() (StandardNormal, "
            "CorrelatedGaussian). The tensor-op tree for other models is "
            "ROADMAP Queue 1 item 6 (run_nuts_tree).")
    chain_block = config.chain_block or DEFAULT_CHAIN_BLOCK

    def kernel(state: ChainState, tuning: bool, generator: torch.Generator,
               seed: Sequence[int]) -> Tuple[ChainState, NUTSInfo]:
        pot = state.potential
        p0 = pot.sample_momentum(generator)
        start_energy = pot.kinetic(p0) - state.logp

        adapting = tuning and config.adapt_step_size
        step_size = state.da.current(adapting)

        # early tree-depth schedule (reference nuts.py:205-208)
        early = tuning & (state.iter_count < config.early_window)
        max_depth_c = torch.where(
            early, torch.full_like(state.iter_count, config.early_max_treedepth),
            torch.full_like(state.iter_count, config.max_treedepth))

        out = trajectory(state.q, p0, state.q_grad, state.logp, step_size,
                         max_depth_c, pot.inverse_mass, seed,
                         spec=trajectory_spec, max_treedepth=config.max_treedepth,
                         Emax=config.Emax, chain_block=chain_block,
                         integrator=config.integrator)

        log_size = out["log_size"]
        mta = torch.where(
            log_size > 0,
            torch.exp(out["log_weighted_accept_sum"] - (log_size + log1mexp(log_size))),
            torch.zeros_like(log_size))
        new_state = finish_step(state, out["q"], out["grad"], out["logp"], mta,
                                tuning, config)
        not_stopped = ~out["diverging"] & ~out["turning"]
        info = NUTSInfo(
            depth=out["depth"],
            step_size=torch.exp(new_state.da.log_step),
            tune=torch.full_like(out["diverging"], tuning),
            mean_tree_accept=mta,
            step_size_bar=torch.exp(new_state.da.log_bar),
            tree_size=out["n_leaves"].to(torch.float32),
            diverging=out["diverging"],
            energy_error=out["energy"] - start_energy,
            energy=out["energy"],
            max_energy_error=out["max_energy_change"],
            model_logp=out["logp"],
            reached_max_treedepth=not_stopped & (not tuning),
        )
        return new_state, info

    return kernel
