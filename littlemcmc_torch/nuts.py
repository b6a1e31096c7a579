"""NUTS transitions on the trajectory op and the fused op, batched over chains.

Counterpart of ``littlemcmc_tpu/nuts.py`` on its kernel paths:

- :func:`build_nuts_kernel` (``:682-917``), the per-draw engine: fresh
  momentum, the step size from dual averaging, the early tree-depth cap,
  one trajectory launch for all chains, then the dual-averaging and metric
  updates; diag metrics, a static dense metric, or a pooled adaptive dense
  metric (``_shared_dense_cov`` ``:642-659``);
- :func:`build_fused_nuts_runner_factory` (``:1006-1326``), the fused
  engine: one fused-op launch per chunk of draws, for a static or an
  adaptive diagonal metric, per chain or pooled at chunk boundaries
  (``diag_static``, ``diag_adapt``, the pooled diag of ``:1259-1271``), a
  static dense metric, or the pooled dense metric refreshed at chunk
  boundaries (``_pool_dense_welford`` ``:927-950``,
  ``_dense_boundary_potential`` ``:967-1003``).

``run_nuts_tree`` (the tree built from separate tensor ops, the engine
for models without a kernel body), the fused low-rank branch and the
low-rank metric are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from .base import ChainState, NUTSConfig, finish_step, pooled_tune_schedule
from .math import log1mexp
from .ops.fused_nuts import WELFORD_KEYS, combine_dense_welford, fused_nuts
from .ops.nuts_trajectory import DEFAULT_CHAIN_BLOCK, TrajectorySpec, trajectory
from .parallel.cross_chain import cross_chain_potential_pool
from .quadpotential import (QuadPotentialDiag, QuadPotentialDiagAdapt, QuadPotentialFull,
                            QuadPotentialFullAdapt, WelfordCovariance, cholesky_or_keep)
from .step_sizes import DualAverageState

__all__ = ["NUTSInfo", "build_nuts_kernel", "build_fused_nuts_runner_factory"]

_NO_TREE = ("littlemcmc_torch runs NUTS only through its kernels, which need a "
            "model with a trajectory_spec() (StandardNormal, CorrelatedGaussian, "
            "EightSchools). "
            "The tensor-op tree for other models is ROADMAP Queue 1 item 6 "
            "(run_nuts_tree).")


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


def _shared_dense_cov(potential, pooled: bool = False) -> Optional[torch.Tensor]:
    """The ``(n, n)`` covariance every chain shares, or None.

    ``QuadPotentialFull`` always qualifies (row 0 of a broadcast).
    ``QuadPotentialFullAdapt`` qualifies only under cross-chain pooled
    adaptation: ``sample()`` overwrites every chain's metric with the pooled
    estimate each tuning step, so row 0 is the shared matrix at every
    kernel entry.
    """
    if isinstance(potential, QuadPotentialFull) or (
            pooled and isinstance(potential, QuadPotentialFullAdapt)):
        return potential.cov[0].contiguous()
    return None


def _trajectory_metric(potential, pooled: bool) -> Tuple[str, torch.Tensor]:
    """``(metric, var)`` of the trajectory op for a chain-batched metric."""
    if isinstance(potential, (QuadPotentialDiag, QuadPotentialDiagAdapt)):
        return "diag", potential.inverse_mass
    cov = _shared_dense_cov(potential, pooled)
    if cov is None:
        raise NotImplementedError(
            "per-chain dense adaptation has no shared covariance for the "
            "trajectory kernel; it runs on the tensor-op tree, ROADMAP Queue 1 "
            "item 6. Use cross_chain_adapt=True (the default at >= 128 chains).")
    return "dense", cov


def build_nuts_kernel(config: NUTSConfig = NUTSConfig(),
                      trajectory_spec: Optional[TrajectorySpec] = None,
                      pooled_metric: bool = False
                      ) -> Callable[..., Tuple[ChainState, NUTSInfo]]:
    """``kernel(state, tuning, generator, seed) -> (state, info)``.

    ``generator`` draws the momenta (on the state's device); ``seed`` is
    the trajectory's two int32 counter-stream words for this draw.
    ``pooled_metric``: the state's adaptive dense metric is pooled across
    chains (``sample()`` pools it after every tuning draw), so its row 0 is
    the covariance the trajectory kernel shares.
    """
    if trajectory_spec is None:
        raise NotImplementedError(_NO_TREE)
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

        metric, var = _trajectory_metric(pot, pooled_metric)
        out = trajectory(state.q, p0, state.q_grad, state.logp, step_size,
                         max_depth_c, var, seed,
                         spec=trajectory_spec, max_treedepth=config.max_treedepth,
                         Emax=config.Emax, chain_block=chain_block,
                         integrator=config.integrator, metric=metric)

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


# --------------------------------------------------------------------------
# The fused engine
# --------------------------------------------------------------------------

def _pool_dense_welford(pot: QuadPotentialFullAdapt):
    """Global pooled moments of a chain-batched ``QuadPotentialFullAdapt``:
    the exact Chan combination over chains of both windows, as full
    ``(mean, raw, weight)`` states, plus the shared counters as 0-d float32
    tensors (reference ``nuts.py:927-950``)."""
    f32 = torch.float32

    def pool(wf):
        nc = wf.n_samples.to(f32)  # (C,)
        N = torch.sum(nc)
        M = torch.sum(nc[:, None] * wf.mean, dim=0) / torch.clamp(N, min=1e-30)
        d = wf.mean - M
        raw = torch.sum(wf.raw_cov, dim=0) + torch.einsum("c,ci,cj->ij", nc, d, d)
        return M, raw, N

    fgM, fgR, fgW = pool(pot.fg)
    bgM, bgR, bgW = pool(pot.bg)
    return (fgM, fgR, fgW, bgM, bgR, bgW, pot.n_samples[0].to(f32),
            pot.prev_update[0].to(f32), pot.window[0].to(f32))


def _dense_boundary_potential(pot: QuadPotentialFullAdapt, outs, c_fg: torch.Tensor,
                              C: int) -> QuadPotentialFullAdapt:
    """The pooled dense metric at a chunk boundary from the fused op's
    per-block Welford states (reference ``nuts.py:967-1003``).

    Chan-combines the blocks, refreshes the shared metric with the pooled
    covariance ``raw / (W - 1)`` and its Cholesky factor (keeping the
    previous factor and latching ``chol_failed`` where it fails), and
    stores the pooled state in replicated per-chain form: each chain
    carries 1/C of the weight at the pooled mean, so Chan-combining the C
    rows gives back the global state and the per-draw engine can take
    over. Rows are views of one matrix; the pooled metric's rows are
    identical before and after.
    """
    Wf, Mf, Rf = combine_dense_welford(outs["dense_fg_w"], outs["dense_fg_mean"],
                                       outs["dense_fg_raw"], c_fg)
    Wb, Mb, Rb = combine_dense_welford(outs["dense_bg_w"], outs["dense_bg_mean"],
                                       outs["dense_bg_raw"], c_fg)
    cov_new = Rf / torch.clamp(Wf - 1.0, min=1.0)
    chol, ok = cholesky_or_keep(cov_new, pot.chol[0])
    n = cov_new.shape[0]
    cov = torch.where(ok, cov_new, pot.cov[0])
    Cf = float(C)

    def rep(x):
        return x.expand(C, *x.shape)

    def counter(k):
        return outs[k].to(torch.int32).expand(C)

    return dataclasses.replace(
        pot, cov=rep(cov), chol=rep(chol), chol_failed=pot.chol_failed | ~ok,
        fg=WelfordCovariance(n_samples=rep(Wf / Cf), mean=rep(Mf), raw_cov=rep(Rf / Cf)),
        bg=WelfordCovariance(n_samples=rep(Wb / Cf), mean=rep(Mb), raw_cov=rep(Rb / Cf)),
        n_samples=counter("n_samples"), prev_update=counter("prev_update"),
        window=counter("window"))


def fused_metric_kind(potential_template, pooled: bool) -> str:
    """Which fused branch runs a metric: ``diag_static``
    (``QuadPotentialDiag``), ``diag_adapt`` (``QuadPotentialDiagAdapt``,
    per chain or, with ``pooled``, pooled at chunk boundaries),
    ``dense_static`` (``QuadPotentialFull``) or ``dense_pooled`` (``pooled``
    and ``QuadPotentialFullAdapt``); raises for any other (reference
    ``nuts.py:1059-1072``)."""
    if isinstance(potential_template, QuadPotentialDiagAdapt):
        return "diag_adapt"
    if isinstance(potential_template, QuadPotentialDiag):
        return "diag_static"
    if isinstance(potential_template, QuadPotentialFull):
        return "dense_static"
    if pooled and isinstance(potential_template, QuadPotentialFullAdapt):
        return "dense_pooled"
    raise NotImplementedError(
        "the fused kernels of littlemcmc_torch run a diagonal metric, a static dense "
        "metric or a cross-chain pooled adaptive dense metric; per-chain dense "
        "adaptation is ROADMAP Queue 1 item 6 and the low-rank branch Queue 1 item 12")


def fused_metric_inputs(kind: str, pot, tuning: bool):
    """``(metric, var, linv, welford, dense_welford)`` of a fused launch
    from the chunk's starting metric (reference ``nuts.py:1106-1139``): the
    shared covariance and ``L^{-1}`` (one triangular solve a chunk) with,
    in pooled tune chunks, the global pooled Welford state; or the
    per-chain inverse-mass diagonals with, in tune chunks of an adaptive
    diag metric, its per-chain Welford state (``_fused_welford_tuple``
    ``:920``). Draw chunks leave an adaptive diag metric as it is, so they
    pass no Welford state."""
    if kind.startswith("dense"):
        cov = pot.cov[0].contiguous()
        eye = torch.eye(cov.shape[0], dtype=cov.dtype, device=cov.device)
        linv = torch.linalg.solve_triangular(pot.chol[0], eye, upper=False)
        pooled_tune = tuning and kind == "dense_pooled"
        return "dense", cov, linv, None, _pool_dense_welford(pot) if pooled_tune else None
    if kind == "diag_adapt":
        return "diag", pot.var, None, pot.welford_leaves() if tuning else None, None
    return "diag", pot.v, None, None, None


def fused_metric_after(pot, outs, tuning: bool, pooled: bool, dense_welford, C: int):
    """The metric at the chunk boundary from the fused op's outputs: an
    adaptive diag metric rebuilt from the updated per-chain state and, in
    pooled tune chunks, pooled across chains once (reference
    ``nuts.py:1223-1274``); the pooled dense metric refreshed from the
    combined block states (:func:`_dense_boundary_potential`); a static
    metric as it was."""
    if "var" in outs:
        pot = pot.with_welford_leaves(outs["var"], [outs[k] for k in WELFORD_KEYS])
        return cross_chain_potential_pool(pot, pooled and tuning)
    if dense_welford is not None:
        return _dense_boundary_potential(pot, outs, dense_welford[0], C)
    return pot


def build_fused_nuts_runner_factory(config: NUTSConfig, trajectory_spec: TrajectorySpec,
                                    potential_template, pooled: bool,
                                    seed_words: Tuple[int, int]):
    """Chunk-runner factory of the fused multi-draw NUTS kernel.

    Returns ``factory(chunk, tuning, collect) -> run_chunk`` with
    ``run_chunk(state, iter0) -> (state, (trace, NUTSInfo) | None, ndiv)``:
    one fused-op launch runs the ``chunk`` transitions that start at global
    iteration ``iter0``. ``trace`` is ``(chunk, C, n)``, every stat of
    ``NUTSInfo`` ``(chunk, C)`` and ``ndiv`` the divergences, a tensor on
    the state's device.

    ``potential_template`` gives the metric's structure
    (:func:`fused_metric_kind`):

    - diagonal (``QuadPotentialDiag``, ``QuadPotentialDiagAdapt``): every
      chunk fused; an adaptive metric runs each chain's Welford updates in
      the kernel through its tune chunks and, with ``pooled``, is pooled
      across chains once at each tune chunk's boundary (mid-chunk each
      chain rides its own estimate, reference ``nuts.py:1073-1088``). Tune
      chunks of ``_AUTO_CHUNK`` draws;
    - static dense (``QuadPotentialFull``): every chunk with the frozen
      metric; momentum ``z @ L^{-1}``, velocities ``p @ cov``;
    - pooled dense (``pooled`` and ``QuadPotentialFullAdapt``): tune chunks
      carry the block-local pooled Welford state on chip and the epilogue
      refreshes the metric at the chunk boundary
      (:func:`_dense_boundary_potential`); draw chunks run with the frozen
      post-tune metric. Tune chunks follow :func:`pooled_tune_schedule`.

    ``seed_words``: the run's two seed words ``(w0, w1)``. Chunk seeds fold
    the global iteration in (``w0 + iter0 * 15485863``), so the draws do not
    depend on the chunking (reference ``nuts.py:1190-1207``).
    """
    kind = fused_metric_kind(potential_template, pooled)
    if trajectory_spec is None:
        raise NotImplementedError(_NO_TREE)
    mult = (potential_template.window_multiplier
            if kind in ("diag_adapt", "dense_pooled") else 1.0)
    w0, w1 = seed_words
    chain_block = config.chain_block or DEFAULT_CHAIN_BLOCK

    def factory(chunk: int, tuning: bool, collect: bool):
        def run_chunk(state: ChainState, iter0: int):
            pot = state.potential
            metric, var, linv, welford, dense_welford = fused_metric_inputs(kind, pot, tuning)
            da = state.da
            outs = fused_nuts(
                state.q, state.q_grad, state.logp, state.iter_count.to(torch.float32),
                da.log_step, da.log_bar, da.hbar, da.count.to(torch.float32), da.mu,
                var, linv, ((w0 + iter0 * 15485863) & 0xFFFFFFFF, w1),
                spec=trajectory_spec, T=chunk, tuning=bool(tuning), config=config,
                metric=metric, window_multiplier=mult, chain_block=chain_block,
                collect_trace=collect, welford=welford, dense_welford=dense_welford)
            new_state = ChainState(
                q=outs["q"], q_grad=outs["grad"], logp=outs["logp"],
                potential=fused_metric_after(pot, outs, tuning, pooled, dense_welford,
                                             state.q.shape[0]),
                da=DualAverageState(log_step=outs["da_log_step"],
                                    log_bar=outs["da_log_bar"], hbar=outs["da_hbar"],
                                    count=outs["da_count"].to(torch.int32),
                                    mu=outs["da_mu"]),
                iter_count=outs["iter_count"].to(torch.int32))
            ndiv = outs["diverging"].sum(dtype=torch.int32)
            if not collect:
                return new_state, None, ndiv
            info = NUTSInfo(
                depth=outs["depth"], step_size=outs["step_size"],
                tune=torch.full_like(outs["diverging"], bool(tuning)),
                mean_tree_accept=outs["mean_tree_accept"],
                step_size_bar=outs["step_size_bar"],
                tree_size=outs["n_leaves"].to(torch.float32),
                diverging=outs["diverging"], energy_error=outs["energy_error"],
                energy=outs["energy"], max_energy_error=outs["max_energy_change"],
                model_logp=outs["model_logp"],
                reached_max_treedepth=(~outs["diverging"] & ~outs["turning"]
                                       & (not tuning)))
            return new_state, (outs["trace"], info), ndiv

        return run_chunk

    if kind == "dense_pooled":
        # the metric refreshes only at chunk boundaries, so the tune chunks
        # are the adaptation schedule (reference nuts.py:1309-1326; the
        # reference's tune_chunk_cap of 50 is never read beside a schedule)
        factory.tune_chunk_schedule = pooled_tune_schedule
    return factory
