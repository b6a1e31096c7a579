"""Classic HMC transitions, batched over chains.

Counterpart of ``littlemcmc_tpu/hmc.py``:

- :func:`run_hmc_trajectory` (``:46-92``), the jittered-length trajectory
  and the Metropolis accept on tensors, with the model called as a
  function: the engine for a model without a kernel body and for a dense
  metric on the per-draw engine (``sampling.py:280-305``);
- :func:`build_hmc_kernel` (``:96-168``) and its kernel path
  (``_build_pallas_hmc_kernel`` ``:171-282``): per draw, the momentum from
  the metric, the path length from the torch generator, one launch of the
  HMC trajectory op for every chain (diag metrics), then dual averaging and
  the metric's Welford update;
- :func:`build_fused_hmc_runner_factory` (``:285-552``), the fused engine
  for a diagonal metric (static, or adapted per chain and pooled at chunk
  boundaries or not), a static dense, a pooled adaptive dense or the pooled
  low-rank metric: one fused-op launch per chunk of draws.

A low-rank metric on the per-draw engine runs the tensor-op trajectory
(the HMC trajectory kernel is diagonal-only). A ``step_rand`` hook runs on
the per-draw engine only.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from .base import ChainState, HMCConfig, finish_step, pooled_tune_schedule
from .integration import IntegratorState, leapfrog, recompute_with_momentum
from .nuts import (_diag_inverse_mass, fused_metric_after, fused_metric_inputs,
                   fused_metric_kind, shard_blocks)
from .ops.fused_hmc import fused_hmc
from .ops.hmc_trajectory import DEFAULT_HMC_CHAIN_BLOCK, hmc_trajectory
from .ops.nuts_trajectory import DEFAULT_CHAIN_BLOCK, TrajectorySpec
from .step_sizes import DualAverageState
from .streams import rand, torch_generator

__all__ = ["HMCConfig", "HMCInfo", "run_hmc_trajectory", "build_hmc_kernel",
           "build_fused_hmc_runner_factory"]

BatchedLogpGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


class HMCInfo(NamedTuple):
    """Per-draw sampler stats, ``(C,)`` each (reference ``hmc.py:36-50``)."""

    step_size: torch.Tensor
    n_steps: torch.Tensor
    tune: torch.Tensor
    step_size_bar: torch.Tensor
    accept: torch.Tensor
    diverging: torch.Tensor
    energy_error: torch.Tensor
    energy: torch.Tensor
    path_length: torch.Tensor
    accepted: torch.Tensor
    model_logp: torch.Tensor


def _select(mask: torch.Tensor, a: IntegratorState, b: IntegratorState) -> IntegratorState:
    """Per chain, ``a`` where ``mask`` else ``b``."""
    return IntegratorState(*(torch.where(mask[:, None] if x.ndim == 2 else mask, x, y)
                             for x, y in zip(a, b)))


def run_hmc_trajectory(generator: torch.Generator, start: IntegratorState,
                       step_size: torch.Tensor, potential, logp_grad_fn: BatchedLogpGrad,
                       config: HMCConfig):
    """Integrate every chain's jittered-length trajectory and Metropolis-accept.

    Equivalent of ``HamiltonianMC._hamiltonian_step`` (reference
    ``hmc.py:140-182``): ``path_length ~ U(0,1) * config.path_length``;
    ``n_steps = clamp(floor(path/eps), 1, max_steps)``; each chain runs its
    own count (the loop runs the largest, chains past theirs stay put);
    divergence on non-finite energy or ``|dE| > Emax``; accept w.p.
    ``min(1, exp(E_start - E_end))``. Returns ``(final, end, accept_stat,
    accepted, diverging, energy_change, path_length, n_steps)``.
    """
    C = start.q.shape[0]
    f = dict(generator=generator, dtype=start.q.dtype, device=start.q.device)
    path_length = rand(C, **f) * config.path_length
    n_steps = torch.clamp((path_length / step_size).to(torch.int32), 1, config.max_steps)

    end = start
    for i in range(int(n_steps.max())):
        end = _select(i < n_steps, leapfrog(potential, logp_grad_fn, step_size, end,
                                            config.integrator), end)

    energy_change = start.energy - end.energy
    energy_change = torch.where(torch.isnan(energy_change),
                                torch.full_like(energy_change, float("-inf")), energy_change)
    diverging = ~torch.isfinite(end.energy) | (energy_change.abs() > config.Emax)
    accept_stat = torch.clamp(torch.exp(energy_change), max=1.0)
    accepted = ~diverging & (rand(C, **f) < accept_stat)
    final = _select(accepted, end, start)
    return final, end, accept_stat, accepted, diverging, energy_change, path_length, n_steps


def build_hmc_kernel(logp_grad_fn: BatchedLogpGrad, config: HMCConfig = HMCConfig(),
                     trajectory_spec: Optional[TrajectorySpec] = None, shard=None
                     ) -> Callable[..., Tuple[ChainState, HMCInfo]]:
    """``kernel(state, tuning, generator, seed) -> (state, info)``.

    ``generator`` draws the momenta and path lengths (and, without a
    ``trajectory_spec``, the accept uniforms) on the state's device: a
    ``torch.Generator``, or a seed list's
    :class:`~littlemcmc_torch.streams.DrawStream`; ``seed`` is the
    trajectory op's two int32 counter-stream words for this draw.
    ``config.step_rand`` (``step_rand(step_size (C,), generator) ->
    (C,)``, the ``torch.Generator``) redraws the step sizes after the
    momentum (reference ``hmc.py:128-129, 190-191``). With a
    ``trajectory_spec`` every chain's trajectory is one launch of the HMC
    trajectory op (a diagonal metric only, reference
    ``hmc.py:201-206``); without one, :func:`run_hmc_trajectory` calls
    ``logp_grad_fn`` (``(C, n) -> ((C,), (C, n))``) step by step.
    ``shard``: the rank's chains under a mesh, which the kernel launches on
    as the global counter-stream blocks they are
    (:func:`~littlemcmc_torch.nuts.shard_blocks`).
    """
    chain_block = config.chain_block or DEFAULT_HMC_CHAIN_BLOCK

    def kernel(state: ChainState, tuning: bool, generator: torch.Generator,
               seed: Sequence[int]) -> Tuple[ChainState, HMCInfo]:
        pot = state.potential
        adapting = tuning and config.adapt_step_size
        step_size = state.da.current(adapting)
        p0 = pot.sample_momentum(generator)
        if config.step_rand is not None:
            step_size = config.step_rand(step_size, torch_generator(generator))
        if trajectory_spec is None:
            start = recompute_with_momentum(pot, state.q, state.q_grad, state.logp, p0)
            final, end, accept_stat, accepted, diverging, energy_change, path_length, \
                n_steps = run_hmc_trajectory(generator, start, step_size, pot, logp_grad_fn,
                                             config)
            q, grad, logp = final.q, final.q_grad, final.model_logp
            energy, model_logp = end.energy, end.model_logp
        else:
            var = _diag_inverse_mass(pot)
            if var is None:
                raise ValueError("the HMC trajectory kernel requires a diagonal metric "
                                 "(QuadPotentialDiag / QuadPotentialDiagAdapt)")
            # the jittered path length from the generator, outside the
            # kernel, as the JAX package draws it in XLA (hmc.py:193-199)
            path_length = rand(state.q.shape[0], generator, state.q.dtype,
                               state.q.device) * config.path_length
            n_steps = torch.clamp((path_length / step_size).to(torch.int32), 1,
                                  config.max_steps)
            out = hmc_trajectory(state.q, p0, state.q_grad, state.logp, step_size, n_steps,
                                 var.contiguous(), seed, spec=trajectory_spec,
                                 Emax=config.Emax, chain_block=chain_block,
                                 integrator=config.integrator,
                                 block0=shard_blocks(shard, state.q.shape[0], chain_block)[0])
            q, grad, logp = out["q"], out["grad"], out["logp"]
            accept_stat, accepted = out["accept_stat"], out["accepted"]
            diverging, energy_change = out["diverging"], out["energy_change"]
            energy, model_logp = out["energy"], out["logp_end"]
        new_state = finish_step(state, q, grad, logp, accept_stat, tuning, config)
        info = HMCInfo(
            step_size=torch.exp(new_state.da.log_step), n_steps=n_steps,
            tune=torch.full_like(diverging, tuning),
            step_size_bar=torch.exp(new_state.da.log_bar), accept=accept_stat,
            diverging=diverging, energy_error=energy_change, energy=energy,
            path_length=path_length, accepted=accepted, model_logp=model_logp)
        return new_state, info

    return kernel


def build_fused_hmc_runner_factory(config: HMCConfig, trajectory_spec: TrajectorySpec,
                                   potential_template, pooled: bool,
                                   seed_words: Tuple[int, int], shard=None):
    """Chunk-runner factory of the fused multi-draw HMC kernel.

    The contract of :func:`littlemcmc_torch.nuts.build_fused_nuts_runner_factory`
    with HMC's stats: ``factory(chunk, tuning, collect) -> run_chunk``,
    ``run_chunk(state, iter0) -> (state, (trace, HMCInfo) | None, ndiv)``,
    and its metrics (:func:`~littlemcmc_torch.nuts.fused_metric_kind`): a
    diagonal metric, static or adapted per chain in the kernel through its
    tune chunks (pooled once at each tune chunk's boundary with
    ``pooled``); a static ``QuadPotentialFull`` with the frozen metric; a
    pooled ``QuadPotentialFullAdapt``, which carries the block-local pooled
    Welford state through its tune chunks and refreshes the shared metric
    at each chunk boundary; a pooled ``QuadPotentialLowRankAdapt``, its
    variances adapted per chain in the kernel and its factor refreshed at
    each tune chunk's boundary; the last two with tune chunks from
    :func:`~littlemcmc_torch.base.pooled_tune_schedule` (reference
    ``hmc.py:285-552``). ``shard``: the rank's chains under a mesh, as the
    NUTS factory's.
    """
    kind = fused_metric_kind(potential_template, pooled)
    group = None if shard is None else shard.group
    if trajectory_spec is None:
        raise NotImplementedError("the fused HMC kernel needs a model with a "
                                  "trajectory_spec() (StandardNormal, CorrelatedGaussian, "
                                  "SpikedGaussian, EightSchools, LogisticRegression)")
    mult = (1.0 if kind.endswith("static") else potential_template.window_multiplier)
    w0, w1 = seed_words
    chain_block = config.chain_block or DEFAULT_CHAIN_BLOCK

    def factory(chunk: int, tuning: bool, collect: bool):
        def run_chunk(state: ChainState, iter0: int):
            pot = state.potential
            C = state.q.shape[0]
            block0, blocks = shard_blocks(shard, C, chain_block)
            m = fused_metric_inputs(kind, pot, tuning, group)
            da = state.da
            outs = fused_hmc(
                state.q, state.q_grad, state.logp, state.iter_count.to(torch.float32),
                da.log_step, da.log_bar, da.hbar, da.count.to(torch.float32), da.mu,
                m["var"], m["linv"], ((w0 + iter0 * 15485863) & 0xFFFFFFFF, w1),
                spec=trajectory_spec, T=chunk, tuning=bool(tuning), config=config,
                metric=m["metric"], window_multiplier=mult, chain_block=chain_block,
                collect_trace=collect, welford=m["welford"],
                dense_welford=m["dense_welford"], fac=m["fac"], block0=block0,
                welford_blocks=blocks)
            new_state = ChainState(
                q=outs["q"], q_grad=outs["grad"], logp=outs["logp"],
                potential=fused_metric_after(pot, outs, tuning, pooled, m["dense_welford"],
                                             C, group),
                da=DualAverageState(log_step=outs["da_log_step"],
                                    log_bar=outs["da_log_bar"], hbar=outs["da_hbar"],
                                    count=outs["da_count"].to(torch.int32),
                                    mu=outs["da_mu"]),
                iter_count=outs["iter_count"].to(torch.int32))
            ndiv = outs["diverging"].sum(dtype=torch.int32)
            if not collect:
                return new_state, None, ndiv
            info = HMCInfo(
                step_size=outs["step_size"], n_steps=outs["n_steps"],
                tune=torch.full_like(outs["diverging"], bool(tuning)),
                step_size_bar=outs["step_size_bar"], accept=outs["accept"],
                diverging=outs["diverging"], energy_error=outs["energy_error"],
                energy=outs["energy"], path_length=outs["path_length"],
                accepted=outs["accepted"], model_logp=outs["model_logp"])
            return new_state, (outs["trace"], info), ndiv

        return run_chunk

    if kind in ("dense_pooled", "lowrank_pooled"):
        # the shared metric refreshes only at chunk boundaries, so the tune
        # chunks are the adaptation schedule (reference hmc.py:539-552)
        factory.tune_chunk_schedule = pooled_tune_schedule
    return factory
