"""T classic-HMC transitions per call: the fused HMC op, for a shared dense
metric, a per-chain inverse-mass diagonal or the pooled low-rank metric.

Counterpart of ``littlemcmc_tpu/ops/fused_hmc_pallas.py::build_fused_hmc_op``
with ``metric="dense"``, static (draw chunks) and with ``adapt_dense``
(pooled dense adaptation inside tune chunks), with ``metric="diag"``,
static and with ``adapt_metric`` (per-chain diag adaptation inside tune
chunks), and with ``metric="lowrank"`` (the variances adapted as the diag
ones, the factor block frozen for the chunk; ``:118-132``, ``:258-277``).
One call runs ``T`` transitions for every chain with the chain state kept
inside the op, and per draw (``:251-325``):

- the momentum ``p = z @ L^{-1}`` (:func:`.fused_nuts.dense_momentum`),
  ``p = z / sqrt(V)`` (:func:`.fused_nuts.diag_momentum`, ``V`` at
  ``:257``, ``:279``) or the low-rank one
  (:func:`.fused_nuts.lowrank_momentum`);
- the jittered path length ``U * path_length`` and
  ``n_steps = clamp(floor(path / eps), 1, max_steps)`` (``:282-286``);
- the trajectory and the accept (:func:`.hmc_trajectory.hmc_transition`,
  velocity ``p @ cov`` or ``V p``);
- dual averaging on the accept statistic, when adapting;
- in tune chunks with ``welford`` (diag), each chain's dual-window Welford
  step on its selected state, which refreshes ``V`` for the next draw
  (``:311-313``, :class:`.fused_nuts.DiagWelford`);
- with ``adapt_dense``, the block-local pooled Welford adds of the block's
  new positions to both windows, then the shared window swap
  (:class:`.fused_nuts._BlockWelford`);
- the trace row and the per-draw stats of :data:`STAT_KEYS`.

Two implementations compute the same function: :func:`fused_hmc_plain`,
plain PyTorch, block by block, for CPU tensors and as the yardstick; and
the CUDA kernel ``csrc/fused_hmc.cu`` for CUDA tensors. :func:`fused_hmc`
picks by the tensors' device and never falls back.

Randomness: per draw ``t`` of block ``i`` the seed word is
``seed0 = w0 + i*7919 + t*15485863`` (``:251``); the JAX body's one call
counter runs through the draw: calls 1 and 2 are the momentum's normals on
the row stream salted ``seed0`` (lanes ``row * Npad + col``), call 3 the
path length and call 4 the accept uniform on the chain stream salted
``seed0`` (``_make_counter_uniform``, ``nuts_trajectory_pallas.py:336-371``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..integration import INTEGRATOR_COEFFS
from .fused_nuts import (_DRAW_STRIDE, _SCALARS, _WELFORD_PTRS, DiagWelford, _BlockWelford,
                         _da_update, check_inputs, check_kernel_shapes, gather_blocks,
                         momentum_and_velocity, padded_dim, state_buffers, state_results,
                         welford_buffers, welford_results)
from .hmc_trajectory import hmc_transition
from .nuts_trajectory import (kernel_library, BODY_IDS, DEFAULT_CHAIN_BLOCK, METRIC_IDS, TrajectorySpec, _M32,
                              _seed_words, body_logp_grad, counter_salt, counter_uniform,
                              int32_bits, resolve_chain_block, shard_seed)

__all__ = ["fused_hmc", "fused_hmc_plain", "STAT_KEYS"]

# per-draw stats the op returns, each (T, C): float32, then n_steps (int32),
# then the flags (bool)
STAT_KEYS = ("step_size", "step_size_bar", "accept", "energy_error", "energy",
             "path_length", "model_logp", "n_steps", "diverging", "accepted")
_STAT_F32 = STAT_KEYS[:7]
# the kernel's pointer, int and float arguments, in the order of
# csrc/fused_hmc.cu
_PTRS = ("q", "grad", "scal", "cov", "linv", "var", "consts", "q_out", "grad_out",
         "scal_out", "var_out", "trace", "stat_f", "stat_i", "stat_b") + _WELFORD_PTRS
_INTS = ("C", "n", "T", "cb", "n_stages", "body", "metric", "tuning", "adapting",
         "adapt_metric", "adapt_dense", "max_steps", "seed0", "seed1", "Npad", "rows")
_FLOATS = ("Emax", "b0", "b1", "b2", "b3", "a0", "a1", "a2", "target_accept", "gamma",
           "k", "t0", "window_multiplier", "path_length")


# --------------------------------------------------------------------------
# The plain version
# --------------------------------------------------------------------------

def fused_hmc_plain(q, grad, logp, iter_count, da_log_step, da_log_bar, da_hbar, da_count,
                    da_mu, var, linv, seed, *, spec: TrajectorySpec, T: int, tuning: bool,
                    config, metric: str = "dense", window_multiplier: float = 1.0,
                    chain_block: int = DEFAULT_CHAIN_BLOCK, collect_trace: bool = True,
                    welford: Optional[Sequence[torch.Tensor]] = None,
                    dense_welford: Optional[Sequence[torch.Tensor]] = None,
                    fac: Optional[torch.Tensor] = None,
                    welford_blocks: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The plain PyTorch op, block by block, on any device."""
    C, n = q.shape
    cb = resolve_chain_block(C, chain_block)
    B = C // cb
    w0, w1 = _seed_words(seed)
    coeffs = INTEGRATOR_COEFFS[config.integrator]
    adapting = tuning and config.adapt_step_size

    def model(x):
        return body_logp_grad(spec, x)

    state = dict(zip(_SCALARS, (logp, iter_count, da_log_step, da_log_bar, da_hbar,
                                da_count, da_mu)))
    outs = []
    for blk in range(B):
        rows = slice(blk * cb, (blk + 1) * cb)
        s = {k: v[rows] for k, v in state.items()}
        qb, gb = q[rows], grad[rows]
        wel = (_BlockWelford(dense_welford, welford_blocks or B) if dense_welford is not None
               else None)
        vb = var if metric == "dense" else var[rows]
        dw = DiagWelford(welford).rows(rows) if welford is not None else None
        per_draw = {k: [] for k in STAT_KEYS + ("trace",)}
        for t in range(T):
            seed0 = (w0 + t * _DRAW_STRIDE) & _M32
            p0, vel = momentum_and_velocity(metric, seed0, w1, blk, cb, vb, linv, fac, offset=0)
            eps = torch.exp(s["da_log_step"] if adapting else s["da_log_bar"])
            salt = counter_salt(seed0, w1, blk, cb, q.device)
            path_length = counter_uniform(salt, 3) * float(config.path_length)
            n_steps = torch.clamp(torch.floor(path_length / eps), 1.0, float(config.max_steps))
            out = hmc_transition(model, vel, coeffs, float(config.Emax),
                                 qb, p0, gb, s["logp"], eps, n_steps, counter_uniform(salt, 4))
            if adapting:
                _da_update(s, out["accept_stat"], config)
            s["iter_count"] = s["iter_count"] + 1.0
            s["logp"] = out["logp"]
            qb, gb = out["q"], out["grad"]
            if dw is not None and tuning:
                vb = dw.update(qb, window_multiplier)
            if wel is not None:
                wel.add_batch(qb)
                wel.swap_and_count(window_multiplier)
            per_draw["trace"].append(qb)
            for k, v in (("step_size", torch.exp(s["da_log_step"])),
                         ("step_size_bar", torch.exp(s["da_log_bar"])),
                         ("accept", out["accept_stat"]), ("energy_error", out["energy_change"]),
                         ("energy", out["energy"]), ("path_length", path_length),
                         ("model_logp", out["logp_end"]), ("n_steps", n_steps.to(torch.int32)),
                         ("diverging", out["diverging"]), ("accepted", out["accepted"])):
                per_draw[k].append(v)
        res = {k: torch.stack(v) for k, v in per_draw.items()}
        res.update(q=qb, grad=gb, **s)
        if dw is not None:
            res.update(var=vb, **dw.leaves)
        if wel is not None:
            res.update(wel.results())
        outs.append(res)
    return gather_blocks(outs, q.device, collect_trace, welford is not None,
                         dense_welford is not None, STAT_KEYS)


# --------------------------------------------------------------------------
# The CUDA kernel's wrapper
# --------------------------------------------------------------------------

def _launch_kernel(q, grad, scalars, var, linv, seed, *, spec, T, tuning, config, metric,
                   window_multiplier, chain_block, collect_trace, welford, dense_welford, fac,
                   welford_blocks):
    from ._build import launch

    C, n = q.shape
    cb = check_kernel_shapes(C, n, chain_block)
    dev = q.device
    w0, w1 = _seed_words(seed)
    b_coef, a_coef = INTEGRATOR_COEFFS[config.integrator]

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    buf = {
        "q": q.contiguous(), "grad": grad.contiguous(),
        "consts": spec.kernel_consts,
        "q_out": empty(C, n), "grad_out": empty(C, n),
        "trace": empty(T, C, n) if collect_trace else None,
        "stat_f": empty(len(_STAT_F32), T, C), "stat_i": empty(T, C, dtype=torch.int32),
        "stat_b": empty(2, T, C, dtype=torch.bool),
    }
    buf.update(state_buffers(scalars, var, linv, metric, welford, empty, fac))
    adapt_dense = dense_welford is not None
    if adapt_dense:
        buf.update(welford_buffers(dense_welford, C // cb, empty, welford_blocks))
    ints = dict(C=C, n=n, T=int(T), cb=cb, n_stages=len(a_coef), body=BODY_IDS[spec.body],
                metric=METRIC_IDS[metric], tuning=int(bool(tuning)),
                adapting=int(bool(tuning) and config.adapt_step_size),
                adapt_metric=int(welford is not None), adapt_dense=int(adapt_dense),
                max_steps=int(config.max_steps), seed0=int32_bits(w0), seed1=int32_bits(w1),
                Npad=padded_dim(n), rows=spec.rows)
    floats = dict(Emax=float(config.Emax), target_accept=float(config.target_accept),
                  gamma=float(config.gamma), k=float(config.k), t0=float(config.t0),
                  window_multiplier=float(window_multiplier),
                  path_length=float(config.path_length))
    floats.update({f"b{i}": (list(b_coef) + [0.0] * 4)[i] for i in range(4)})
    floats.update({f"a{i}": (list(a_coef) + [0.0] * 3)[i] for i in range(3)})
    launch("fused_hmc", [buf[k].data_ptr() if buf.get(k) is not None else None for k in _PTRS],
           [ints[k] for k in _INTS], [floats[k] for k in _FLOATS], dev,
           lib=kernel_library("fused_hmc", spec, dev, C))
    fused_hmc.launches += 1

    res = {"trace": buf["trace"], "q": buf["q_out"], "grad": buf["grad_out"]}
    res.update(state_results(buf))
    res.update({k: buf["stat_f"][i] for i, k in enumerate(_STAT_F32)})
    res.update(n_steps=buf["stat_i"], diverging=buf["stat_b"][0], accepted=buf["stat_b"][1])
    if adapt_dense:
        res.update(welford_results(buf))
    return res


def fused_hmc(q, grad, logp, iter_count, da_log_step, da_log_bar, da_hbar, da_count, da_mu,
              var, linv, seed, *, spec: TrajectorySpec, T: int, tuning: bool, config,
              metric: str = "dense", window_multiplier: float = 1.0,
              chain_block: int = DEFAULT_CHAIN_BLOCK, collect_trace: bool = True,
              welford: Optional[Sequence[torch.Tensor]] = None,
              dense_welford: Optional[Sequence[torch.Tensor]] = None,
              fac: Optional[torch.Tensor] = None, block0: int = 0,
              welford_blocks: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """``T`` HMC transitions for every chain, where the tensors lie.

    The inputs of :func:`.fused_nuts.fused_nuts`, with ``config`` an
    :class:`~littlemcmc_torch.base.HMCConfig`. Returns the JAX op's dict
    (``fused_hmc_pallas.py:538-577``): ``trace`` ``(T, C, n)`` (None
    without ``collect_trace``), the per-draw stats of :data:`STAT_KEYS`
    ``(T, C)``, the final state leaves, with ``welford`` the updated
    ``var`` and Welford leaves, and with ``dense_welford`` the per-block
    Welford states and shared counters of
    :func:`.fused_nuts.combine_dense_welford`'s input. ``block0`` and
    ``welford_blocks`` shard the chains as :func:`.fused_nuts.fused_nuts`'s.

    CPU tensors run :func:`fused_hmc_plain`; CUDA tensors launch the kernel
    (``fused_hmc.launches`` counts those launches) or raise.
    """
    scalars = (logp, iter_count, da_log_step, da_log_bar, da_hbar, da_count, da_mu)
    check_inputs(spec, q, grad, scalars, var, linv, metric, welford, dense_welford, tuning,
                 fac)
    kw = dict(spec=spec, T=T, tuning=tuning, config=config, metric=metric,
              window_multiplier=window_multiplier, chain_block=chain_block,
              collect_trace=collect_trace, welford=welford, dense_welford=dense_welford,
              fac=fac, welford_blocks=welford_blocks)
    seed = shard_seed(seed, block0)
    if q.device.type == "cpu":
        return fused_hmc_plain(q, grad, *scalars, var, linv, seed, **kw)
    if q.device.type == "cuda":
        return _launch_kernel(q, grad, scalars, var, linv, seed, **kw)
    raise RuntimeError(f"no fused HMC implementation for device {q.device}")


fused_hmc.launches = 0
