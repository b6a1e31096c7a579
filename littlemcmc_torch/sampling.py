"""Sampling driver: the public ``sample()`` / ``init_nuts()`` entry points.

Counterpart of ``littlemcmc_tpu/sampling.py`` for the subset this package
runs: NUTS with a diagonal metric (``adapt_diag`` / ``jitter+adapt_diag``,
per-chain ``QuadPotentialDiagAdapt`` plus dual averaging), every chain
advanced together by one trajectory-kernel launch per draw. The host runs
a plain Python loop over ``tune + draws`` transitions; the trace and stats
stay on the device until the end.

Outputs match the JAX package: ``trace`` is a ``(chains, draws, ndim)``
numpy array and ``stats`` maps the reference's stat names to
``(chains, draws)`` numpy arrays with the reference's dtypes
(``littlemcmc_tpu/nuts.py:899-914``, ``sampling.py:127-143``).
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Union

import numpy as np
import torch

from .base import NUTSConfig, init_chain_state
from .device import resolve_device
from .model import as_logp_grad, batched
from .nuts import build_nuts_kernel
from .ops.nuts_trajectory import DEFAULT_CHAIN_BLOCK, trajectory
from .quadpotential import QuadPotentialDiag, QuadPotentialDiagAdapt
from .report import warnings_from_stats

__all__ = ["NUTS", "sample", "init_nuts"]

_log = logging.getLogger("littlemcmc_torch")

_INIT_METHODS = ("adapt_diag", "jitter+adapt_diag")


class NUTS:
    """No-U-Turn sampler spec (constructor parity with reference ``nuts.py:103-121``).

    ``trajectory_spec``: ``"auto"`` takes the model's ``trajectory_spec()``
    (the model body the trajectory kernel inlines); or pass a
    :class:`~littlemcmc_torch.ops.TrajectorySpec`.
    """

    name = "nuts"
    generates_stats = True
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
                 integrator: str = "leapfrog", trajectory_spec="auto",
                 chain_block: int = 0):
        del is_cov, path_length  # accepted for constructor parity
        if scaling is not None:
            raise NotImplementedError(
                "`scaling` needs the quad_potential factory and the dense "
                "metrics, which are ROADMAP Queue 1 item 8; pass a diagonal "
                "`potential` instead.")
        if step_rand is not None:
            raise NotImplementedError("`step_rand` is not ported yet.")
        if potential is not None and not isinstance(
                potential, (QuadPotentialDiag, QuadPotentialDiagAdapt)):
            raise ValueError("`potential` must be a littlemcmc_torch diagonal "
                             "quadpotential (QuadPotentialDiag or "
                             "QuadPotentialDiagAdapt).")
        self.logp_dlogp_func = logp_dlogp_func
        self.model_ndim = model_ndim
        self.potential = potential
        self.trajectory_spec = trajectory_spec
        self.config = NUTSConfig(
            target_accept=float(target_accept), Emax=float(Emax),
            adapt_step_size=bool(adapt_step_size), step_scale=float(step_scale),
            gamma=float(gamma), k=float(k), t0=float(t0),
            integrator=str(integrator), chain_block=int(chain_block),
            max_treedepth=int(max_treedepth),
            early_max_treedepth=int(early_max_treedepth),
        )
        self._last_stats = None
        self._last_trace = None

    def warnings(self, stats=None, *, tune: int = 0, trace=None):
        """End-of-run sampler warnings of the last ``sample()`` run (or of
        ``stats``), as the reference's ``step.warnings()``."""
        if stats is None:
            if self._last_stats is None:
                return []
            stats, trace = self._last_stats, self._last_trace
        return warnings_from_stats(stats, target_accept=self.config.target_accept,
                                   max_treedepth=self.config.max_treedepth,
                                   tune=int(tune), trace=trace)


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
            f"{', '.join(_INIT_METHODS)} (the dense and low-rank metrics are "
            "ROADMAP Queue 1 items 8 and 12).")
    return init_l


def init_nuts(logp_dlogp_func=None, model_ndim: Optional[int] = None,
              init: str = "auto", random_seed: Optional[int] = None,
              logp_fn=None, device=None, **kwargs):
    """Set up mass-matrix initialization for NUTS (reference ``sampling.py:524-605``).

    Returns ``(start, step)``: one ``(ndim,)`` starting point (uniform in
    ``[-1, 1)`` for ``jitter+``) and a :class:`NUTS` spec carrying the
    adaptive diagonal metric. ``sample()`` jitters per chain itself.
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
    potential = QuadPotentialDiagAdapt.create(
        start, torch.ones_like(start), initial_weight=10.0)
    return start, NUTS(logp_dlogp_func=logp_dlogp_func, model_ndim=model_ndim,
                       potential=potential, **kwargs)


def _resolve_spec(step: NUTS, logp_grad):
    spec = step.trajectory_spec
    if spec != "auto":
        return spec
    owner = getattr(logp_grad, "__self__", None)
    spec_fn = getattr(owner, "trajectory_spec", None)
    return spec_fn() if spec_fn is not None else None


def sample(
    logp_dlogp_func=None,
    model_ndim: Optional[int] = None,
    draws: int = 1000,
    tune: int = 1000,
    step: Optional[NUTS] = None,
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
    return_final_state: bool = False,
    compute_convergence_checks: bool = True,
    perf_report: Optional[dict] = None,
    device=None,
    **kwargs,
):
    """Draw posterior samples with NUTS on the CUDA card (or the CPU).

    The signature follows the JAX package's ``sample()``; this slice runs
    NUTS with ``init`` in ``adapt_diag`` / ``jitter+adapt_diag`` and a model
    that carries a trajectory spec. ``device=None`` means ``"cuda"`` and
    raises when no CUDA device exists; ``device="cpu"`` runs the plain
    PyTorch trajectory. ``cores``, ``chain_idx``, ``mp_ctx`` and
    ``pickle_backend`` are accepted and ignored, as in the JAX package.

    ``perf_report``: pass a dict and it is filled with ``engine``
    (``per_draw_diag``), ``trajectory`` (``cuda`` or ``plain``),
    ``chain_block``, ``kernel_launches`` (trajectory-kernel launches in
    this call) and ``sample_seconds`` (the transition loop; CUDA events on
    the card).

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
    if step is None:
        step = NUTS(model_ndim=model_ndim, **kwargs)
    elif kwargs:
        _log.warning("`step` was provided; ignoring step-method kwargs: %s "
                     "(set them on the step constructor instead)", sorted(kwargs))
    spec = _resolve_spec(step, logp_grad)
    config = step.config

    seed = _as_seed(random_seed)
    # one generator on the device for starts and momenta, one on the host
    # for the trajectory kernel's per-draw counter-stream seeds
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
        potential = step.potential.broadcast(chains)
    else:
        potential = QuadPotentialDiagAdapt.create(
            starts, torch.ones_like(starts), initial_weight=10.0)
    state = init_chain_state(starts, potential, config, batched(logp_grad))

    # fail fast on a bad start, as the reference's "Bad initial energy"
    # check (base_hmc.py:145-148), for all chains at once
    if not bool(torch.isfinite(state.logp).all()):
        raise ValueError(
            "Bad initial energy: model log-probability is not finite at the "
            "starting point. The model might be misspecified.")

    kernel = build_nuts_kernel(config, spec)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (tune + draws, 2),
                          generator=host_gen, dtype=torch.int64).tolist()
    if progressbar:
        _log.info("Sampling %d chains (%d tune + %d draws) on %s...",
                  chains, tune, draws, dev)

    launches0 = trajectory.launches
    on_card = dev.type == "cuda"
    if on_card:
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
    t0 = time.perf_counter()
    qs, infos = [], []
    for i in range(tune + draws):
        tuning = i < tune
        state, info = kernel(state, tuning, gen, seeds[i])
        if not tuning or not discard_tuned_samples:
            qs.append(state.q)
            infos.append(info)
    if on_card:
        ev1.record()
        ev1.synchronize()
        elapsed = ev0.elapsed_time(ev1) / 1000.0
    else:
        elapsed = time.perf_counter() - t0

    dtypes = step.stats_dtypes[0]
    if qs:
        trace = torch.stack(qs, dim=1).cpu().numpy()
        stats = {name: torch.stack([getattr(x, name) for x in infos], dim=1)
                 .cpu().numpy().astype(dt) for name, dt in dtypes.items()}
    else:
        trace = np.zeros((chains, 0, model_ndim), np.float32)
        stats = {name: np.zeros((chains, 0), dt) for name, dt in dtypes.items()}

    if perf_report is not None:
        perf_report.update(
            engine="per_draw_diag",
            trajectory="cuda" if on_card else "plain",
            chain_block=config.chain_block or DEFAULT_CHAIN_BLOCK,
            kernel_launches=trajectory.launches - launches0,
            sample_seconds=elapsed,
        )
    if progressbar:
        _log.info("Done in %.2fs (%.0f transitions/s).", elapsed,
                  chains * (tune + draws) / elapsed)

    step._last_stats = stats
    step._last_trace = trace
    if trace.shape[1] > 0 and compute_convergence_checks:
        # R-hat scans the trace per dimension on the host: skipped for
        # traces above 50M values, as in the JAX package
        tuned = 0 if discard_tuned_samples else tune
        for w in warnings_from_stats(
                stats, target_accept=config.target_accept,
                max_treedepth=config.max_treedepth, tune=tuned,
                trace=trace if trace.size <= 50_000_000 else None):
            (_log.error if w.level == "error" else _log.warning)(
                "%s: %s", w.kind.name, w.message)

    if return_final_state:
        return trace, stats, state
    return trace, stats
