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
end.

Outputs match the JAX package: ``trace`` is a ``(chains, draws, ndim)``
numpy array and ``stats`` maps the reference's stat names to
``(chains, draws)`` numpy arrays with the reference's dtypes
(``littlemcmc_tpu/nuts.py:899-914``, ``sampling.py:127-143``).
"""

from __future__ import annotations

import dataclasses
import logging
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

    def __init__(self, logp_dlogp_func, model_ndim, scaling, is_cov, potential, step_rand,
                 trajectory_spec):
        if scaling is not None and potential is not None:
            raise ValueError("Cannot specify both `potential` and `scaling`.")
        if step_rand is not None:
            raise NotImplementedError("`step_rand` is not ported yet.")
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
        super().__init__(logp_dlogp_func, model_ndim, scaling, is_cov, potential, step_rand,
                         trajectory_spec)
        self.batched_logp_dlogp_func = batched_logp_dlogp_func
        self.config = NUTSConfig(
            target_accept=float(target_accept), Emax=float(Emax),
            adapt_step_size=bool(adapt_step_size), step_scale=float(step_scale),
            gamma=float(gamma), k=float(k), t0=float(t0),
            integrator=str(integrator), chain_block=int(chain_block),
            max_treedepth=int(max_treedepth),
            early_max_treedepth=int(early_max_treedepth),
        )


class HamiltonianMC(_StepSpec):
    """Classic HMC spec (constructor parity with reference ``hmc.py:52-69``).

    Each draw integrates a jittered path of ``U(0, 1) * path_length`` in
    steps of the adapted step size (at most ``max_steps``) and
    Metropolis-accepts its end.
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
        super().__init__(logp_dlogp_func, model_ndim, scaling, is_cov, potential, step_rand,
                         trajectory_spec)
        self.config = HMCConfig(
            target_accept=float(target_accept), Emax=float(Emax),
            adapt_step_size=bool(adapt_step_size), step_scale=float(step_scale),
            gamma=float(gamma), k=float(k), t0=float(t0),
            integrator=str(integrator), chain_block=int(chain_block),
            path_length=float(path_length), max_steps=int(max_steps),
        )


def _as_seed(random_seed) -> int:
    if random_seed is None:
        return int(np.random.randint(2 ** 30))
    if isinstance(random_seed, (int, np.integer)):
        return int(random_seed)
    raise NotImplementedError(
        "random_seed must be an int or None; per-chain seed lists are not "
        "ported yet.")


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


def _per_draw_factory(kernel, generator: torch.Generator, seeds, pooled: bool):
    """Chunk runners of the per-draw engine, with the fused factory's
    contract: ``run_chunk(state, iter0) -> (state, (trace, info) | None,
    ndiv)``; a pooled metric is pooled after every tuning draw (the
    low-rank one with the draw's positions, reference ``sampling.py:
    575-580``)."""

    def factory(chunk: int, tuning: bool, collect: bool):
        def run_chunk(state, iter0: int):
            qs, infos, ndiv = [], [], 0
            for i in range(iter0, iter0 + chunk):
                state, info = kernel(state, tuning, generator, seeds[i])
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


def _run_chunked(factory, state, tune: int, draws: int, collect_tune: bool):
    """Run ``tune + draws`` transitions chunk by chunk (the core of the
    reference's ``_run_chunked``, ``sampling.py:686-876``).

    Chunks are ``_AUTO_CHUNK`` draws; tune chunks follow the factory's
    ``tune_chunk_schedule`` where it has one, since a boundary-cadence
    metric refreshes only between chunks. Returns the final state, the
    collected ``(trace, info)`` chunks and the divergence count (a device
    tensor).
    """
    total = tune + draws
    done, outs, ndiv = 0, [], 0
    sched = getattr(factory, "tune_chunk_schedule", None)
    while done < total:
        tuning = done < tune
        step_len = _AUTO_CHUNK
        if tuning and sched is not None:
            step_len = min(step_len, sched(done))
        stop = min(tune if tuning else total, done + step_len)
        collect = collect_tune if tuning else True
        state, out, nd = factory(stop - done, tuning, collect)(state, done)
        if collect:
            outs.append(out)
        ndiv = ndiv + nd
        done = stop
    return state, outs, ndiv


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
    random_seed: Optional[Union[int, List[int]]] = None,
    discard_tuned_samples: bool = True,
    chain_idx: int = 0,
    callback=None,
    logp_fn=None,
    mp_ctx=None,
    pickle_backend: str = "pickle",
    cross_chain_adapt: Optional[bool] = None,
    return_final_state: bool = False,
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
    JAX package.

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
      this call, by kernel name) and ``sample_seconds`` (the chunk loop;
      CUDA events on the card).

    Returns ``(trace, stats)`` (plus the final ``ChainState`` with
    ``return_final_state``).
    """
    del cores, chain_idx, mp_ctx, pickle_backend
    if callback is not None:
        raise NotImplementedError("`callback` is ROADMAP Queue 1 item 13.")
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

    seed = _as_seed(random_seed)
    # one generator on the device for starts and momenta, one on the host
    # for the kernels' counter-stream seeds
    gen = torch.Generator(device=dev).manual_seed(seed)
    host_gen = torch.Generator().manual_seed(seed + 1)

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
        starts = 2.0 * torch.rand((chains, model_ndim), generator=gen, device=dev) - 1.0
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
        factory = _per_draw_factory(kernel, gen, seeds, pooled)
    if progressbar:
        _log.info("Sampling %d chains (%d tune + %d draws) on %s, engine %s...",
                  chains, tune, draws, dev, engine)

    launches0 = {name: op.launches for name, op in counters.items()}
    if on_card:
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
    t0 = time.perf_counter()
    state, outs, ndiv = _run_chunked(factory, state, tune, draws,
                                        collect_tune=not discard_tuned_samples)
    if on_card:
        ev1.record()
        ev1.synchronize()
        elapsed = ev0.elapsed_time(ev1) / 1000.0
    else:
        elapsed = time.perf_counter() - t0

    dtypes = step.stats_dtypes[0]
    if outs:
        trace = torch.cat([o[0] for o in outs]).transpose(0, 1).cpu().numpy()
        stats = {name: torch.cat([getattr(o[1], name) for o in outs]).transpose(0, 1)
                 .cpu().numpy().astype(dt) for name, dt in dtypes.items()}
    else:
        trace = np.zeros((chains, 0, model_ndim), np.float32)
        stats = {name: np.zeros((chains, 0), dt) for name, dt in dtypes.items()}

    if perf_report is not None:
        perf_report.update(
            engine=engine,
            trajectory=trajectory_kind,
            chain_block=chain_block,
            chunk=_AUTO_CHUNK,
            kernel_launches={name: op.launches - launches0[name]
                             for name, op in counters.items()},
            sample_seconds=elapsed,
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
