"""Sampling driver: the public ``sample()`` / ``init_nuts()`` entry points.

Counterpart of ``littlemcmc_tpu/sampling.py`` for the subset this package
runs: NUTS or classic HMC (``NUTS``, ``HamiltonianMC``) on any model, with
a diagonal metric (``adapt_diag`` / ``jitter+adapt_diag``, per-chain
``QuadPotentialDiagAdapt``, optionally pooled across chains), a dense one
(``adapt_full`` / ``jitter+adapt_full``, per chain or pooled across
chains, or a static ``QuadPotentialFull`` / ``QuadPotentialFullInv``) or a
low-rank one (``adapt_lowrank`` / ``jitter+adapt_lowrank``,
``QuadPotentialLowRankAdapt``, per chain or pooled across chains), with
dual averaging. Two engines:

- per-draw: one trajectory-kernel launch per draw for all chains where the
  model has a kernel body and the kernel takes the metric, else the
  tensor-op tree of ``nuts.run_nuts_tree`` (NUTS) or the tensor-op
  trajectory of ``hmc.run_hmc_trajectory`` (HMC, also for any dense
  metric), the adaptation updates between draws;
- fused: one fused-kernel launch per chunk of draws, with momentum, dual
  averaging and the metric's Welford updates (per-chain diag, pooled
  dense, or the low-rank metric's per-chain variances) inside it.

``sample`` elects between them by the JAX package's rule
(``sampling.py:1237-1300``, ``elect_fused_engine`` ``:660-683``) with one
deliberate departure: ``trajectory_spec="auto"`` takes the model's spec
for a dense metric too, where the JAX package resolves one only for a
diagonal metric or pooled low-rank (``:1077-1105``). So
``init="adapt_full"`` at 128 chains or more runs ``fused_dense_pooled``
here and ``per_draw_dense_pooled`` there: on the card the fused engine
takes 1.445 s against 3.42-4.72 s per draw (on an H100, ``PERF.md`` section 6).

Both run in the chunk loop of ``_run_chunked`` (``sampling.py:686-876``):
tune chunks follow the fused engine's refresh schedule, the divergence
count stays on the device, and the trace and stats stay there until the
end; between chunks it gives progress lines, callbacks and checkpoints
(:mod:`littlemcmc_torch.utils.checkpoint`) where the caller asks for them.

Outputs match the JAX package: ``trace`` is a ``(chains, draws, ndim)``
numpy array and ``stats`` maps the reference's stat names to
``(chains, draws)`` numpy arrays with the reference's dtypes
(``littlemcmc_tpu/nuts.py:899-914``, ``sampling.py:127-143``).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import sys
import time
from typing import List, Optional, Union

import numpy as np
import torch

from .base import HMCConfig, NUTSConfig, init_chain_state
from .device import resolve_device
from .hmc import build_fused_hmc_runner_factory, build_hmc_kernel
from .model import as_logp_grad, batched
from .nuts import build_fused_nuts_runner_factory, build_nuts_kernel, trajectory_metric
from .ops.fused_hmc import fused_hmc
from .ops.fused_nuts import fused_nuts
from .ops.hmc_trajectory import DEFAULT_HMC_CHAIN_BLOCK, hmc_trajectory
from .ops.nuts_trajectory import DEFAULT_CHAIN_BLOCK, trajectory
from .parallel.cross_chain import cross_chain_potential_pool
from .quadpotential import (QuadPotentialDiag, QuadPotentialDiagAdapt, QuadPotentialFull,
                            QuadPotentialFullAdapt, QuadPotentialFullInv,
                            QuadPotentialLowRankAdapt, potential_to, quad_potential)
from .report import warnings_from_stats
from .streams import ChainStreams

__all__ = ["NUTS", "HamiltonianMC", "sample", "init_nuts"]

_log = logging.getLogger("littlemcmc_torch")

_INIT_METHODS = ("adapt_diag", "jitter+adapt_diag", "adapt_full", "jitter+adapt_full",
                 "adapt_lowrank", "jitter+adapt_lowrank")

# draws per chunk (reference sampling.py:644)
_AUTO_CHUNK = 250

# chain count at which adapt_full and adapt_lowrank auto-promote to
# cross-chain pooled adaptation (reference sampling.py:648)
_POOLED_PROMOTE_CHAINS = 128

_POTENTIALS = (QuadPotentialDiag, QuadPotentialDiagAdapt, QuadPotentialFull,
               QuadPotentialFullAdapt, QuadPotentialFullInv, QuadPotentialLowRankAdapt)
_DIAG = (QuadPotentialDiag, QuadPotentialDiagAdapt)
_DENSE = (QuadPotentialFull, QuadPotentialFullAdapt, QuadPotentialFullInv)

# the JAX kernels' lane width and per-chain slot scalars, which set how many
# chains of an n-parameter model share a lane row there
# (nuts_trajectory_pallas.py:66-67)
_LANE, _N_SCALARS = 128, 4


def _resolve_pack(spec, n: int, chains: int) -> int:
    """The JAX package's lane-pack factor for a run (``natural_pack`` and
    ``resolve_pack``, ``nuts_trajectory_pallas.py:820-847``): the largest
    power of two up to 16 whose ``128 / pack``-lane segments hold ``n + 4``
    lanes, for a packable model, demoted until ``chains`` blocks into rows
    of 8. Nothing in the port packs lanes; the factor decides the engine."""
    if not spec.packable:
        return 1
    pack, seg = 1, _LANE
    while pack * 2 <= 16 and seg // 2 >= n + _N_SCALARS:
        pack, seg = pack * 2, seg // 2
    while pack > 1 and chains % (8 * pack):
        pack //= 2
    return pack


def _usable_chain_count(chains: int, chain_block: int = 256) -> bool:
    """Whether ``chains`` blocks into chain blocks of at least 8 by the
    JAX kernels' rule (``usable_chain_count``,
    ``nuts_trajectory_pallas.py:93-102``)."""
    cb = min(chain_block, chains)
    while chains % cb:
        cb //= 2
    return cb >= 8


class _StepSpec:
    """What both step methods' specs share: the model, the metric (a static
    one from ``scaling`` with :func:`quad_potential`, a 1-D diagonal or a
    dense covariance with ``is_cov=True``), the model body the kernels
    inline (``trajectory_spec``: ``"auto"`` takes the model's
    ``trajectory_spec()``, else on the card a body generated from the
    model, :func:`~littlemcmc_torch.ops.autospec.try_auto_spec`; or pass a
    :class:`~littlemcmc_torch.ops.TrajectorySpec`, such as
    :func:`~littlemcmc_torch.ops.autospec.make_trajectory_spec`'s), and the
    end-of-run warnings."""

    generates_stats = True

    def __init__(self, logp_dlogp_func, model_ndim, scaling, is_cov, potential,
                 trajectory_spec):
        if scaling is not None and potential is not None:
            raise ValueError("Cannot specify both `potential` and `scaling`.")
        if potential is not None and not isinstance(potential, _POTENTIALS):
            raise ValueError("`potential` must be a littlemcmc_torch quadpotential "
                             "(QuadPotentialDiag, QuadPotentialDiagAdapt, "
                             "QuadPotentialFull, QuadPotentialFullAdapt, "
                             "QuadPotentialFullInv or QuadPotentialLowRankAdapt).")
        self.logp_dlogp_func = logp_dlogp_func
        self.model_ndim = model_ndim
        self.potential = (potential if scaling is None
                          else quad_potential(scaling, is_cov))
        self.trajectory_spec = trajectory_spec
        self._last_stats = None
        self._last_trace = None
        self._last_tune = 0

    def warnings(self, stats=None, *, tune: Optional[int] = None, trace=None):
        """End-of-run sampler warnings of the last ``sample()`` run (or of
        ``stats``), as the reference's ``step.warnings()``. ``tune`` marks
        the leading tuning columns to leave out; by default, for the last
        run, the tuning draws it kept (``discard_tuned_samples=False``),
        as the JAX package's ``step._last_tune`` (``sampling.py:106-113``)."""
        if stats is None:
            if self._last_stats is None:
                return []
            stats = self._last_stats
            if tune is None:
                tune = self._last_tune
            if trace is None:
                trace = self._last_trace
        return warnings_from_stats(stats, target_accept=self.config.target_accept,
                                   max_treedepth=getattr(self.config, "max_treedepth", None),
                                   tune=int(tune or 0), trace=trace)


class NUTS(_StepSpec):
    """No-U-Turn sampler spec (constructor parity with reference ``nuts.py:103-121``).

    ``batched_logp_dlogp_func``: a natively batched ``(C, n) -> ((C,), (C,
    n))`` model, e.g. a batched model kernel, that the tensor-op tree calls
    instead of the model's own batched form or a vmap of
    ``logp_dlogp_func`` (the JAX package's ``sampling.py:164``).
    ``trajectory_spec=None`` keeps a model off the trajectory kernels.
    ``step_rand``: ``step_rand(step_size, generator) -> step_size``, called
    before every trajectory with the ``(chains,)`` step sizes and the run's
    device ``torch.Generator`` (the port's counterpart of the JAX hook's
    key); the engine is then per-draw (reference ``nuts.py:737-738``).
    """

    name = "nuts"
    stats_dtypes = [
        {
            "depth": np.int64,
            "step_size": np.float64,
            "tune": np.bool_,
            "mean_tree_accept": np.float64,
            "step_size_bar": np.float64,
            "tree_size": np.float64,
            "diverging": np.bool_,
            "energy_error": np.float64,
            "energy": np.float64,
            "max_energy_error": np.float64,
            "model_logp": np.float64,
            "reached_max_treedepth": np.bool_,
        }
    ]

    def __init__(self, logp_dlogp_func=None, model_ndim: Optional[int] = None,
                 scaling=None, is_cov: bool = False, potential=None,
                 target_accept: float = 0.8, Emax: float = 1000,
                 adapt_step_size: bool = True, step_scale: float = 0.25,
                 gamma: float = 0.05, k: float = 0.75, t0: int = 10,
                 step_rand=None, path_length: float = 2.0,
                 max_treedepth: int = 10, early_max_treedepth: int = 8,
                 integrator: str = "leapfrog", batched_logp_dlogp_func=None,
                 trajectory_spec="auto", chain_block: int = 0):
        del path_length  # accepted for constructor parity
        super().__init__(logp_dlogp_func, model_ndim, scaling, is_cov, potential,
                         trajectory_spec)
        self.batched_logp_dlogp_func = batched_logp_dlogp_func
        self.config = NUTSConfig(
            target_accept=float(target_accept), Emax=float(Emax),
            adapt_step_size=bool(adapt_step_size), step_scale=float(step_scale),
            gamma=float(gamma), k=float(k), t0=float(t0),
            integrator=str(integrator), chain_block=int(chain_block), step_rand=step_rand,
            max_treedepth=int(max_treedepth),
            early_max_treedepth=int(early_max_treedepth),
        )


class HamiltonianMC(_StepSpec):
    """Classic HMC spec (constructor parity with reference ``hmc.py:52-69``).

    Each draw integrates a jittered path of ``U(0, 1) * path_length`` in
    steps of the adapted step size (at most ``max_steps``) and
    Metropolis-accepts its end. ``step_rand`` as :class:`NUTS`'s, called
    after the momentum (reference ``hmc.py:128-129, 190-191``).
    """

    name = "hmc"
    stats_dtypes = [
        {
            "step_size": np.float64,
            "n_steps": np.int64,
            "tune": np.bool_,
            "step_size_bar": np.float64,
            "accept": np.float64,
            "diverging": np.bool_,
            "energy_error": np.float64,
            "energy": np.float64,
            "path_length": np.float64,
            "accepted": np.bool_,
            "model_logp": np.float64,
        }
    ]

    def __init__(self, logp_dlogp_func=None, model_ndim: Optional[int] = None,
                 scaling=None, is_cov: bool = False, potential=None,
                 target_accept: float = 0.8, Emax: float = 1000,
                 adapt_step_size: bool = True, step_scale: float = 0.25,
                 gamma: float = 0.05, k: float = 0.75, t0: int = 10,
                 step_rand=None, path_length: float = 2.0, max_steps: int = 1024,
                 integrator: str = "leapfrog", trajectory_spec="auto",
                 chain_block: int = 0):
        super().__init__(logp_dlogp_func, model_ndim, scaling, is_cov, potential,
                         trajectory_spec)
        self.config = HMCConfig(
            target_accept=float(target_accept), Emax=float(Emax),
            adapt_step_size=bool(adapt_step_size), step_scale=float(step_scale),
            gamma=float(gamma), k=float(k), t0=float(t0),
            integrator=str(integrator), chain_block=int(chain_block), step_rand=step_rand,
            path_length=float(path_length), max_steps=int(max_steps),
        )


def _as_seed(random_seed) -> int:
    """One master seed: the seed, a new one for None, the first of a seed
    list (``init_nuts``' one start; reference ``sampling.py:403-411``)."""
    if random_seed is None:
        return int(np.random.randint(2 ** 30))
    if isinstance(random_seed, (int, np.integer)):
        return int(random_seed)
    return int(np.atleast_1d(np.asarray(random_seed))[0])


def _chain_seeds(random_seed, chains: int) -> Optional[List[int]]:
    """A seed list's seeds, one per chain, or None for a master seed (None,
    an int, a 0-d array), as the JAX package's ``_resolve_chain_keys``
    (``sampling.py:414-440``)."""
    if (random_seed is None or isinstance(random_seed, (int, np.integer))
            or np.ndim(random_seed) == 0):
        return None
    seeds = np.asarray(random_seed).ravel()
    if seeds.size != chains:
        raise ValueError("random_seed must be an int or a sequence with one seed per "
                         f"chain ({chains}); got {seeds.size} seeds.")
    return [int(x) for x in seeds]


def _resolve_init(init: str) -> str:
    if not isinstance(init, str):
        raise TypeError("init must be a string.")
    init_l = init.lower()
    if init_l == "auto":
        init_l = "jitter+adapt_diag"
    if init_l not in _INIT_METHODS:
        raise ValueError(
            f"Unknown initializer: {init}. littlemcmc_torch supports "
            f"{', '.join(_INIT_METHODS)}.")
    return init_l


def _init_metric_kind(init_l: str) -> str:
    """``"full"``, ``"lowrank"`` or ``"diag"`` from a lowercased init method
    (reference ``sampling.py:329-335``)."""
    if init_l.endswith("adapt_full"):
        return "full"
    if init_l.endswith("adapt_lowrank"):
        return "lowrank"
    return "diag"


def _make_adaptive_potential(kind: str, mean: torch.Tensor):
    """The default adaptive metric over ``mean`` (``(n,)`` or ``(C, n)``),
    as built by ``init_nuts`` (reference ``sampling.py:305-326``)."""
    n = mean.shape[-1]
    if kind == "full":
        return QuadPotentialFullAdapt.create(
            mean, torch.eye(n, dtype=mean.dtype, device=mean.device), initial_weight=10.0)
    if kind == "lowrank":
        return QuadPotentialLowRankAdapt.create(mean, torch.ones_like(mean),
                                                initial_weight=10.0)
    return QuadPotentialDiagAdapt.create(mean, torch.ones_like(mean), initial_weight=10.0)


def init_nuts(logp_dlogp_func=None, model_ndim: Optional[int] = None,
              init: str = "auto", random_seed: Optional[int] = None,
              logp_fn=None, device=None, **kwargs):
    """Set up mass-matrix initialization for NUTS (reference ``sampling.py:524-605``).

    Returns ``(start, step)``: one ``(ndim,)`` starting point (uniform in
    ``[-1, 1)`` for ``jitter+``) and a :class:`NUTS` spec carrying the
    adaptive metric (diagonal, dense for ``adapt_full``, low-rank for
    ``adapt_lowrank``). ``sample()`` jitters per chain itself.
    """
    init_l = _resolve_init(init)
    if model_ndim is None:
        raise ValueError("model_ndim is required.")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(_as_seed(random_seed))
    if init_l.startswith("jitter"):
        start = 2.0 * torch.rand(model_ndim, generator=gen, device=dev) - 1.0
    else:
        start = torch.zeros(model_ndim, device=dev)
    if logp_fn is not None:
        logp_dlogp_func = as_logp_grad(logp_dlogp_func, logp_fn)
    potential = _make_adaptive_potential(_init_metric_kind(init_l), start)
    return start, NUTS(logp_dlogp_func=logp_dlogp_func, model_ndim=model_ndim,
                       potential=potential, **kwargs)


def _resolve_spec(step: _StepSpec, logp_grad, lowrank_per_chain: bool, user_fn,
                  is_logp_only: bool, model_ndim: int, dev: torch.device):
    """The model body the kernels inline: the step's spec, or for ``"auto"``
    the model's ``trajectory_spec()``, else on a CUDA device the body
    generated from the user's callable ``user_fn``
    (:func:`~littlemcmc_torch.ops.autospec.try_auto_spec`; None, with a log
    line, where the model declines at trace time), as the JAX package
    auto-lowers on a TPU only (``sampling.py:1103-1128``); on the CPU a
    user model runs on the tree. ``"auto"`` resolves none for per-chain
    low-rank adaptation, which no kernel runs, as in the JAX package
    (``sampling.py:1077-1105``); unlike it, it resolves the spec for a
    dense metric (the departure the module docstring gives)."""
    spec = step.trajectory_spec
    if spec != "auto":
        return spec
    if lowrank_per_chain:
        return None
    owner = getattr(logp_grad, "__self__", None)
    spec_fn = getattr(owner, "trajectory_spec", None)
    if spec_fn is not None:
        return spec_fn()
    if dev.type != "cuda" or user_fn is None:
        return None
    from .ops.autospec import try_auto_spec

    spec = try_auto_spec(user_fn, model_ndim, is_logp_only, dev)
    if spec is not None:
        _log.info("Auto-lowered the model into the CUDA trajectory kernels' body "
                  "(pass trajectory_spec=None to disable).")
    return spec


def _capability_checks(dev: torch.device, fused_auto: bool, lowrank_kernel: bool) -> None:
    """The JAX election's capability probes (``sampling.py:1088-1095,
    1278-1290``) as self-checks on the card, which raise where a probe
    disagrees (:mod:`~littlemcmc_torch.ops.fused_probe`): the fused
    kernels' where ``fuse_draws=None`` elects the fused engine
    (``fused_auto``), the low-rank branch's where a kernel runs the pooled
    low-rank metric (``lowrank_kernel``). Nothing runs off the card, as the
    JAX package probes only on a TPU."""
    if dev.type != "cuda":
        return
    from .ops.fused_probe import fused_engine_check, lowrank_kernel_check

    if fused_auto:
        fused_engine_check(dev)
    if lowrank_kernel:
        lowrank_kernel_check(dev)


def _per_draw_factory(kernel, generator: torch.Generator, seeds, pooled: bool,
                      streams: Optional[ChainStreams] = None):
    """Chunk runners of the per-draw engine, with the fused factory's
    contract: ``run_chunk(state, iter0) -> (state, (trace, info) | None,
    ndiv)``; a pooled metric is pooled after every tuning draw (the
    low-rank one with the draw's positions, reference ``sampling.py:
    575-580``). With a seed list's ``streams`` each draw takes its own
    :class:`~littlemcmc_torch.streams.DrawStream` in place of
    ``generator``."""

    def factory(chunk: int, tuning: bool, collect: bool):
        def run_chunk(state, iter0: int):
            qs, infos, ndiv = [], [], 0
            for i in range(iter0, iter0 + chunk):
                gen_i = generator if streams is None else streams.draw(i)
                state, info = kernel(state, tuning, gen_i, seeds[i])
                if pooled and tuning:
                    state = dataclasses.replace(
                        state, potential=cross_chain_potential_pool(state.potential, True,
                                                                    state.q))
                ndiv = ndiv + info.diverging.sum(dtype=torch.int32)
                if collect:
                    qs.append(state.q)
                    infos.append(info)
            if not collect:
                return state, None, ndiv
            return state, (torch.stack(qs), type(infos[0])(
                *(torch.stack(f) for f in zip(*infos)))), ndiv

        return run_chunk

    return factory


def _stderr_is_tty() -> bool:
    try:
        return sys.stderr.isatty()
    except Exception:  # noqa: BLE001 - a closed or replaced stderr
        return False


def _emit_progress(chains: int, done: int, total: int, tuning: bool, ndiv: int, t0: float,
                   final: bool = False) -> None:
    """One progress update: an in-place bar on a TTY, else a log line
    (reference ``sampling.py:509-533``)."""
    rate = chains * done / max(time.perf_counter() - t0, 1e-9)
    phase = "tuning" if tuning else "sampling"
    if _stderr_is_tty():
        width = 28
        filled = int(width * done / max(total, 1))
        bar = "\u2588" * filled + "\u2591" * (width - filled)
        sys.stderr.write(f"\r|{bar}| {done}/{total} [{phase}] "
                         f"{ndiv} divergences, {rate:,.0f} transitions/s  ")
        if final:
            sys.stderr.write("\n")
        sys.stderr.flush()
    else:
        _log.info("  %d/%d iterations (%s), %d divergences, %.0f transitions/s",
                  done, total, phase, ndiv, rate)


def _base_chunk(progress_every: Optional[int], checkpoint_every: Optional[int]) -> int:
    """Draws per chunk: ``_AUTO_CHUNK``, or the gcd of the progress and
    checkpoint intervals given, or the smaller one where that gcd is
    below 25 and the larger fires late (reference ``sampling.py:733-748``)."""
    given = [int(k) for k in (progress_every, checkpoint_every) if k]
    if not given:
        return _AUTO_CHUNK
    if len(given) == 1:
        return given[0]
    base = math.gcd(*given)
    return base if base >= 25 else min(given)


def _run_chunked(factory, state, tune: int, draws: int, collect_tune: bool, *,
                 done: int = 0, ndiv=0, chunk: int = _AUTO_CHUNK, aligned: bool = False,
                 progress_every: Optional[int] = None, progress: bool = False,
                 checkpoint_every: Optional[int] = None, save=None, callback=None,
                 chains: int = 0):
    """Run transitions ``done`` to ``tune + draws`` chunk by chunk (the
    reference's ``_run_chunked``, ``sampling.py:686-876``).

    Chunks are ``chunk`` draws (``aligned``: chunks end at the multiples
    of ``chunk`` and at the end of tuning, so a checkpoint every ``chunk``
    draws lands on those multiples); tune chunks follow the factory's
    ``tune_chunk_schedule`` where it has one, since a boundary-cadence
    metric refreshes only between chunks. ``ndiv`` (the divergences so far)
    stays on the device; the host reads it only where a progress line
    (``progress_every`` with ``progress``), a checkpoint (``save(state,
    done, n_divergences)`` every ``checkpoint_every``) or ``callback(
    iteration, tuning, states, chunk, n_divergences)``, called after every
    chunk, needs it. A ``KeyboardInterrupt`` returns the chunks completed
    so far and, with ``save``, checkpoints the last completed chunk's state.
    Returns the state, the collected ``(trace, info)`` chunks and the
    divergence count.
    """
    total = tune + draws
    outs = []
    t0 = time.perf_counter()
    next_progress = done + progress_every if progress_every else None
    next_checkpoint = done + checkpoint_every if (save and checkpoint_every) else None
    sched = getattr(factory, "tune_chunk_schedule", None)
    try:
        while done < total:
            tuning = done < tune
            step_len = chunk - done % chunk if aligned else chunk
            if tuning and sched is not None:
                step_len = min(step_len, sched(done))
            stop = min(tune if tuning else total, done + step_len)
            collect = collect_tune if tuning else True
            state, out, nd = factory(stop - done, tuning, collect)(state, done)
            if collect:
                outs.append(out)
            ndiv = ndiv + nd
            done = stop

            due_progress = next_progress is not None and done >= next_progress
            due_checkpoint = next_checkpoint is not None and done >= next_checkpoint
            n_div = None
            if callback is not None or due_checkpoint or (due_progress and progress):
                n_div = int(ndiv)
            if callback is not None:
                callback(iteration=done, tuning=tuning, states=state, chunk=out,
                         n_divergences=n_div)
            if due_progress:
                if progress:
                    _emit_progress(chains, done, total, done <= tune, n_div, t0,
                                   final=done >= total)
                next_progress = done + progress_every
            if due_checkpoint:
                save(state, done, n_div)
                next_checkpoint = done + checkpoint_every
    except KeyboardInterrupt:
        _log.warning("Sampling interrupted at iteration %d/%d: returning the %d chunk(s) "
                     "collected so far.", done, total, len(outs))
        if save:
            save(state, done, int(ndiv))
            _log.warning("Saved an interrupt checkpoint at iteration %d.", done)
    return state, outs, ndiv


# The JAX ``sample()``'s arguments that the port names but does not run
# yet: each one's default there (``littlemcmc_tpu/sampling.py:897-899``)
# and the ROADMAP Queue 1 item that ports it. Any other value raises.
_UNPORTED_ARGUMENTS = {
    "mesh": (None, 14), "chain_axis": ("chains", 14), "model_axis": (None, 14),
    "dtype": (torch.float32, 17),
}


def sample(
    logp_dlogp_func=None,
    model_ndim: Optional[int] = None,
    draws: int = 1000,
    tune: int = 1000,
    step: Optional[_StepSpec] = None,
    init: str = "auto",
    chains: Optional[int] = None,
    cores: Optional[int] = None,
    start=None,
    progressbar: Union[bool, str] = True,
    random_seed: Optional[Union[int, List[int], np.ndarray]] = None,
    discard_tuned_samples: bool = True,
    chain_idx: int = 0,
    callback=None,
    logp_fn=None,
    mp_ctx=None,
    pickle_backend: str = "pickle",
    mesh=None,
    chain_axis: str = "chains",
    model_axis: Optional[str] = None,
    dtype=torch.float32,
    cross_chain_adapt: Optional[bool] = None,
    return_final_state: bool = False,
    progress_every: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
    fuse_draws: Optional[bool] = None,
    compute_convergence_checks: bool = True,
    perf_report: Optional[dict] = None,
    device=None,
    **kwargs,
):
    """Draw posterior samples with NUTS or HMC on the CUDA card (or the CPU).

    The signature follows the JAX package's ``sample()``; this port runs
    ``step`` (:class:`NUTS`, the default, or :class:`HamiltonianMC`) with
    ``init`` in ``adapt_diag`` / ``jitter+adapt_diag`` / ``adapt_full`` /
    ``jitter+adapt_full`` / ``adapt_lowrank`` / ``jitter+adapt_lowrank`` (or
    a metric on the step), on any model:
    through the kernels where the model has a trajectory spec and the
    kernels take the metric, else on tensor ops. ``device=None`` means
    ``"cuda"`` and raises when no CUDA device exists; ``device="cpu"`` runs
    the kernels' plain PyTorch versions. ``cores``, ``chain_idx``,
    ``mp_ctx`` and ``pickle_backend`` are accepted and ignored, as in the
    JAX package. ``mesh``, ``chain_axis``, ``model_axis`` and ``dtype``
    take the JAX package's defaults (``dtype`` float32); any other value
    raises ``NotImplementedError`` naming the ROADMAP item that ports it.

    - ``random_seed``: an int (or a 0-d array, or None for a new one) seeds
      the run; a sequence with one seed per chain gives each chain its own
      counter stream (:mod:`littlemcmc_torch.streams`): on the tensor-op
      paths (the NUTS tree, HMC's tensor trajectory) a chain's draws then
      depend on its own seed alone, whatever its slot or neighbours; the
      kernels' per-draw words, the starts' order and a ``step_rand`` hook's
      generator come from chain 0's seed, as the JAX kernels' words do
      (``littlemcmc_tpu/nuts.py:800-802``).
    - ``progress_every``: chunks of that many draws, a progress line after
      each (with ``progressbar``) with the divergences so far. Without it
      (and without the arguments below) the chunks are 250 draws and the
      host reads nothing between them.
    - ``callback``: ``callback(iteration, tuning, states, chunk,
      n_divergences)`` after every chunk (the reference's per-draw hook,
      ``sampling.py:307-308``, amortized over the chunk; ``progress_every=1``
      for the per-draw contract). A ``KeyboardInterrupt`` between chunks
      (from the callback or the user) returns the chunks completed so far.
    - ``checkpoint_dir``, ``checkpoint_every``, ``resume``: a checkpoint
      (:mod:`littlemcmc_torch.utils.checkpoint`) every ``checkpoint_every``
      draws and at an interrupt; ``resume=True`` continues from the latest
      one bit-identically and returns only the draws after it (with a
      warning where it covered part of the requested draws). The draws are
      keyed on the seed and the global iteration, so ``progress_every`` and
      ``checkpoint_every`` do not change them on the per-draw engines or on
      the fused ones with a static or per-chain metric. A pooled metric on
      the fused engines refreshes at every chunk boundary (the diagonal
      one at each tune chunk's, the dense and low-rank ones at
      ``pooled_tune_schedule``'s and every boundary inside it, as the JAX
      package's ``sampling.py:763-772``), so there a chunking other than
      the default's changes the draws; a resumed run continues the chunking
      it was saved under only where its intervals are the same.

    - ``cross_chain_adapt``: pool the metric's Welford statistics across
      all chains. ``None`` pools ``adapt_full`` and ``adapt_lowrank`` at
      >= 128 chains (reference ``sampling.py:1040-1055``). Per-chain dense
      and low-rank adaptation run on the per-draw engine's tensor ops
      (engines ``per_draw_dense``, ``per_draw_lowrank``).
    - ``fuse_draws``: ``None`` elects the engine by the JAX package's
      rule (with the dense departure of the module docstring): the fused
      kernels for a model with a spec, at a chain count that blocks into
      chain blocks of at least 8, and a dense metric (static or pooled),
      the pooled low-rank one, or a diagonal one (static, or adaptive per
      chain or pooled) where the JAX kernels would pack lanes (a packable
      model, ``StandardNormal`` or ``EightSchools``, at n <= 60 and a chain
      count that is a multiple of 16 or more; ``elect_fused_engine``);
      else per-draw. On the card a fused election by ``None`` first runs
      the fused kernels' capability probes, and a kernel with the pooled
      low-rank metric the low-rank one (``ops/fused_probe.py``). ``False``
      forces the per-draw engine; ``True`` requires the fused one and
      raises ``ValueError`` where it does not run. A failed build, launch
      or probe raises; nothing falls back. NUTS on the
      per-draw engine launches its trajectory kernel for a model with a
      spec and a metric the kernel takes (diagonal, static dense, pooled
      dense, pooled low-rank), else runs
      :func:`~littlemcmc_torch.nuts.run_nuts_tree`; HMC runs its trajectory
      kernel for a diagonal metric and a model with a spec, else
      :func:`~littlemcmc_torch.hmc.run_hmc_trajectory`.
    - ``perf_report``: pass a dict and it is filled with ``engine`` (e.g.
      ``fused_dense_pooled``), ``trajectory`` (``cuda`` or ``plain`` for the
      kernels or their plain versions, ``tensor`` for the NUTS tree or
      HMC's tensor-op trajectory), ``chain_block``, ``chunk`` (draws per chunk),
      ``kernel_launches`` (launches of each of the step method's kernels in
      this call, by kernel name), ``sample_seconds`` (the chunk loop;
      CUDA events on the card) and ``transfer_seconds`` (the trace's and
      stats' fetch to the host).

    Returns ``(trace, stats)`` (plus the final ``ChainState`` with
    ``return_final_state``).
    """
    del cores, chain_idx, mp_ctx, pickle_backend
    given = dict(mesh=mesh, chain_axis=chain_axis, model_axis=model_axis, dtype=dtype)
    for name, (default, item) in _UNPORTED_ARGUMENTS.items():
        value = given[name]
        if not (value is default or (isinstance(default, str) and value == default)):
            raise NotImplementedError(f"`{name}` is ROADMAP Queue 1 item {item}.")
    if resume and not checkpoint_dir:
        raise ValueError("resume=True requires checkpoint_dir")
    dev = resolve_device(device)
    chains = 4 if chains is None else int(chains)
    if model_ndim is None:
        if step is not None and step.model_ndim is not None:
            model_ndim = step.model_ndim
        else:
            raise ValueError("model_ndim is required.")
    if draws == 0:
        _log.warning("Tuning was enabled throughout the whole trace.")
    elif draws < 500:
        _log.warning("Only %s samples in chain.", draws)

    logp_grad = as_logp_grad(
        logp_dlogp_func if logp_dlogp_func is not None
        else (step.logp_dlogp_func if step is not None else None),
        logp_fn)
    init_l = _resolve_init(init)
    kind = _init_metric_kind(init_l)
    if step is None:
        step = NUTS(model_ndim=model_ndim, **kwargs)
    elif kwargs:
        _log.warning("`step` was provided; ignoring step-method kwargs: %s "
                     "(set them on the step constructor instead)", sorted(kwargs))
    config = step.config

    # pool adapt_full and adapt_lowrank across chains from
    # _POOLED_PROMOTE_CHAINS chains on
    lowrank = (isinstance(step.potential, QuadPotentialLowRankAdapt)
               or (step.potential is None and kind == "lowrank"))
    if cross_chain_adapt is None:
        poolable = (kind in ("full", "lowrank") or lowrank
                    or isinstance(step.potential, QuadPotentialFullAdapt))
        cross_chain_adapt = poolable and chains >= _POOLED_PROMOTE_CHAINS
    pooled = bool(cross_chain_adapt)
    user_fn = (logp_dlogp_func if logp_dlogp_func is not None
               else step.logp_dlogp_func if step.logp_dlogp_func is not None else logp_fn)
    spec = _resolve_spec(step, logp_grad, lowrank and not pooled, user_fn,
                         logp_dlogp_func is None and step.logp_dlogp_func is None,
                         model_ndim, dev)

    chain_seeds = _chain_seeds(random_seed, chains)
    seed = _as_seed(random_seed)
    # one generator on the device for starts and momenta, one on the host
    # for the kernels' counter-stream seeds; a seed list's chains draw from
    # their own streams instead
    gen = torch.Generator(device=dev).manual_seed(seed)
    host_gen = torch.Generator().manual_seed(seed + 1)
    streams = None if chain_seeds is None else ChainStreams(chain_seeds, dev, gen)

    if start is not None:
        start = torch.as_tensor(start, dtype=torch.float32, device=dev)
        if start.ndim == 1:
            starts = start.expand(chains, model_ndim).clone()
        elif tuple(start.shape) != (chains, model_ndim):
            raise ValueError(f"start must have shape ({chains}, {model_ndim}), "
                             f"got {tuple(start.shape)}")
        else:
            starts = start
    elif init_l.startswith("jitter"):
        u = (torch.rand((chains, model_ndim), generator=gen, device=dev) if streams is None
             else streams.draw(-1).uniform((model_ndim,)))
        starts = 2.0 * u - 1.0
    else:
        starts = torch.zeros((chains, model_ndim), device=dev)

    if step.potential is not None:
        potential = potential_to(step.potential, dev).broadcast(chains)
    else:
        potential = _make_adaptive_potential(kind, starts)
    dense = isinstance(potential, _DENSE)
    diag = isinstance(potential, _DIAG)
    # the kernels take a diagonal metric, a static dense one and a pooled
    # adaptive dense or low-rank one; per-chain dense and low-rank
    # adaptation and QuadPotentialFullInv run on tensor ops
    kernel_metric = trajectory_metric(potential, pooled) is not None
    hmc = isinstance(step, HamiltonianMC)
    # the JAX election (sampling.py:1237-1300): the fused kernels run a
    # model with a spec, at a chain count that blocks into rows of 8, with
    # a dense metric, the pooled low-rank one or a diagonal one (a static
    # diagonal is not pooled); fuse_draws=None takes a diagonal metric
    # there only where the JAX kernels pack lanes (elect_fused_engine,
    # sampling.py:660-683)
    fusable = (spec is not None and kernel_metric and _usable_chain_count(chains)
               and (not diag or not pooled or isinstance(potential, QuadPotentialDiagAdapt)))
    if fuse_draws is True and config.step_rand is not None:
        raise ValueError("fuse_draws=True but the step has a step_rand hook: the fused "
                         "kernels draw no host-side step sizes (reference "
                         "sampling.py:1241, 1338); pass fuse_draws=None or False.")
    fusable = fusable and config.step_rand is None
    if fuse_draws is True and not fusable:
        raise ValueError(
            "fuse_draws=True but the fused kernels do not run this configuration: "
            "they need a model with a trajectory_spec() (StandardNormal, "
            "CorrelatedGaussian, SpikedGaussian, EightSchools, LogisticRegression, "
            "NealsFunnel, NonCenteredFunnel, HierarchicalRegression, or on the card a "
            "body generated from the model), a "
            "chain count that blocks into chain blocks of at least 8, and a diagonal "
            "metric (a static diagonal one not pooled across chains), a static "
            "QuadPotentialFull or a pooled adaptive dense or low-rank metric.")
    if fuse_draws is None:
        fused = fusable and (not diag or _resolve_pack(spec, model_ndim, chains) > 1)
    else:
        fused = bool(fuse_draws)
    metric_tag = "dense" if dense else "diag" if diag else "lowrank"
    engine = (("fused_" if fused else "per_draw_") + metric_tag
              + ("_pooled" if pooled else ""))
    _capability_checks(dev, fused and fuse_draws is None,
                       metric_tag == "lowrank" and kernel_metric and spec is not None
                       and (fused or not hmc))

    batched_fn = getattr(step, "batched_logp_dlogp_func", None) or batched(logp_grad)
    state = init_chain_state(starts, potential, config, batched_fn)
    # fail fast on a bad start, as the reference's "Bad initial energy"
    # check (base_hmc.py:145-148), for all chains at once
    if not bool(torch.isfinite(state.logp).all()):
        raise ValueError(
            "Bad initial energy: model log-probability is not finite at the "
            "starting point. The model might be misspecified.")

    # the kernels' launch counters of this step method, by kernel name
    counters = ({"hmc_trajectory": hmc_trajectory, "fused_hmc": fused_hmc} if hmc
                else {"nuts_trajectory": trajectory, "fused_nuts": fused_nuts})
    on_card = dev.type == "cuda"
    trajectory_kind = "cuda" if on_card else "plain"
    chain_block = config.chain_block or DEFAULT_CHAIN_BLOCK
    if fused:
        words = torch.randint(-2 ** 31, 2 ** 31, (2,), generator=host_gen,
                              dtype=torch.int64).tolist()
        build = build_fused_hmc_runner_factory if hmc else build_fused_nuts_runner_factory
        factory = build(config, spec, potential, pooled, words)
    else:
        if hmc:
            # the per-draw HMC kernel is diagonal-only (reference
            # sampling.py:287-298, 1350-1353)
            hmc_spec = spec if diag else None
            kernel = build_hmc_kernel(batched_fn, config, hmc_spec)
            if hmc_spec is None:
                trajectory_kind = "tensor"
            else:
                chain_block = config.chain_block or DEFAULT_HMC_CHAIN_BLOCK
        else:
            nuts_spec = spec if kernel_metric else None
            kernel = build_nuts_kernel(config, nuts_spec, pooled_metric=pooled,
                                       batched_logp_grad_fn=batched_fn)
            if nuts_spec is None:
                trajectory_kind = "tensor"
        seeds = torch.randint(-2 ** 31, 2 ** 31, (tune + draws, 2),
                              generator=host_gen, dtype=torch.int64).tolist()
        factory = _per_draw_factory(kernel, gen, seeds, pooled, streams)

    done0, ndiv0 = 0, 0
    if resume:
        from .utils.checkpoint import latest_checkpoint, restore_checkpoint

        path = latest_checkpoint(checkpoint_dir)
        if path is not None:
            state, meta = restore_checkpoint(path, state)
            done0 = int(meta.get("step", 0))
            ndiv0 = torch.tensor(int(meta.get("n_divergences", 0)), dtype=torch.int32,
                                 device=dev)
            gen.set_state(meta["extra"]["generator"])
            if fused:
                factory = build(config, spec, potential, pooled,
                                [int(w) for w in meta["extra"]["seed_words"]])
            _log.info("Resumed from %s at iteration %d/%d.", path, done0, tune + draws)
    save = None
    if checkpoint_dir:
        from .utils.checkpoint import save_checkpoint

        def save(st, done, n_div):
            save_checkpoint(checkpoint_dir, st, done,
                            meta={"n_divergences": n_div, "tune": tune, "draws": draws},
                            extra={"generator": gen.get_state(),
                                   "seed_words": words if fused else None})
    chunk = _base_chunk(progress_every, checkpoint_every if checkpoint_dir else None)
    if progressbar:
        _log.info("Sampling %d chains (%d tune + %d draws) on %s, engine %s...",
                  chains, tune, draws, dev, engine)

    launches0 = {name: op.launches for name, op in counters.items()}
    if on_card:
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
    t0 = time.perf_counter()
    state, outs, ndiv = _run_chunked(
        factory, state, tune, draws, collect_tune=not discard_tuned_samples, done=done0,
        ndiv=ndiv0, chunk=chunk, aligned=chunk != _AUTO_CHUNK or done0 > 0,
        progress_every=progress_every, progress=bool(progressbar),
        checkpoint_every=checkpoint_every, save=save, callback=callback, chains=chains)
    if on_card:
        ev1.record()
        ev1.synchronize()
        elapsed = ev0.elapsed_time(ev1) / 1000.0
    else:
        elapsed = time.perf_counter() - t0

    dtypes = step.stats_dtypes[0]
    t_xfer = time.perf_counter()
    if outs:
        trace = torch.cat([o[0] for o in outs]).transpose(0, 1).cpu().numpy()
        stats = {name: torch.cat([getattr(o[1], name) for o in outs]).transpose(0, 1)
                 .cpu().numpy().astype(dt) for name, dt in dtypes.items()}
    else:
        trace = np.zeros((chains, 0, model_ndim), np.float32)
        stats = {name: np.zeros((chains, 0), dt) for name, dt in dtypes.items()}
    transfer = time.perf_counter() - t_xfer
    expected = draws + (0 if discard_tuned_samples else tune)
    if resume and trace.shape[1] < expected:
        _log.warning("Resume: the restored checkpoint already covered %d of the %d requested "
                     "draws; only the remaining %d were sampled and returned. Pass a larger "
                     "`draws` (or a fresh checkpoint_dir) for a full trace.",
                     expected - trace.shape[1], expected, trace.shape[1])

    if perf_report is not None:
        perf_report.update(
            engine=engine,
            trajectory=trajectory_kind,
            chain_block=chain_block,
            chunk=chunk,
            kernel_launches={name: op.launches - launches0[name]
                             for name, op in counters.items()},
            sample_seconds=elapsed,
            transfer_seconds=transfer,
        )
    if progressbar:
        _log.info("Done in %.2fs (%.0f transitions/s, %d divergences).", elapsed,
                  chains * (tune + draws) / elapsed, int(ndiv))

    step._last_stats = stats
    step._last_tune = 0 if discard_tuned_samples else tune
    step._last_trace = trace
    if trace.shape[1] > 0 and compute_convergence_checks:
        # R-hat scans the trace per dimension on the host: skipped for
        # traces above 50M values, as in the JAX package
        tuned = 0 if discard_tuned_samples else tune
        for w in warnings_from_stats(
                stats, target_accept=config.target_accept,
                max_treedepth=getattr(config, "max_treedepth", None), tune=tuned,
                trace=trace if trace.size <= 50_000_000 else None):
            (_log.error if w.level == "error" else _log.warning)(
                "%s: %s", w.kind.name, w.message)

    if return_final_state:
        return trace, stats, state
    return trace, stats
