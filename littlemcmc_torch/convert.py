"""Carry sampler state across from the JAX package, as numpy arrays.

The JAX package's chain-batched ``ChainState`` (``littlemcmc_tpu/base.py``)
flattens to named numpy arrays; the names are the attribute paths of its
leaves, joined with dots::

    q, q_grad, logp, iter_count, da.{log_step, log_bar, hbar, count, mu},

and the metric's leaves, by kind:

- ``QuadPotentialDiagAdapt``: ``potential.{var, stds, inv_stds}``,
  ``potential.fg.{w_sum, w_sum2, mean, raw_var}``, ``potential.bg.{...}``,
  ``potential.n_samples``, ``potential.window``;
- ``QuadPotentialFull``: ``potential.{cov, chol}``;
- ``QuadPotentialFullAdapt``: ``potential.{cov, chol, chol_failed}``,
  ``potential.fg.{n_samples, mean, raw_cov}``, ``potential.bg.{...}``,
  ``potential.{n_samples, prev_update, window}``.

- ``QuadPotentialFullInv``: ``potential.chol``;
- ``QuadPotentialLowRankAdapt``: the diag adaptation's leaves, then
  ``potential.{vecs, lam, alpha, lam_w, lam_s2, alpha_s2, buf, buf_pos,
  buf_fill}``.

(``rng_key`` is ignored: the port draws from ``torch.Generator`` objects.)
:func:`chain_state_from_numpy` builds the port's :class:`ChainState` with
the metric the leaves name, and :func:`chain_state_to_numpy` is its
inverse. A metric's static fields (``window_multiplier``, the dense
adaptation's ``update_window`` and ``regularize``, the low-rank one's
``lam_clip``) are not leaves: pass them as keywords (the low-rank
``rank`` and ``buffer_size`` are read from the leaves' shapes). :func:`spec_consts_from_numpy`
turns a JAX model spec's constants, zero-padded to the TPU kernel's lane
width, into the port's unpadded ones. :func:`phase_state_from_numpy` and
:func:`tree_node_from_numpy` carry the tensor-op tree's ``PhaseState`` and
``TreeNode`` (``littlemcmc_tpu/nuts.py:68-104``) across, field by field,
so both trees can start from the same state. :func:`config_from_fields`
carries a step method's config (``NUTSConfig`` or ``HMCConfig``,
``littlemcmc_tpu/base.py:25-64``) from its fields, e.g.
``dataclasses.asdict(cfg)``, and :func:`config_to_fields` is its inverse.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .base import ChainState, HMCConfig, NUTSConfig
from .nuts import PhaseState, TreeNode
from .quadpotential import (QuadPotentialDiagAdapt, QuadPotentialFull, QuadPotentialFullAdapt,
                            QuadPotentialFullInv, QuadPotentialLowRankAdapt,
                            WelfordCovariance, WelfordVariance)
from .step_sizes import DualAverageState

__all__ = ["chain_state_from_numpy", "chain_state_to_numpy", "spec_consts_from_numpy",
           "phase_state_from_numpy", "tree_node_from_numpy", "config_from_fields",
           "config_to_fields"]

_WELFORD = ("w_sum", "w_sum2", "mean", "raw_var")
_WELFORD_COV = ("n_samples", "mean", "raw_cov")
_DA = ("log_step", "log_bar", "hbar", "count", "mu")
_DIAG_ADAPT = ("var", "stds", "inv_stds", "n_samples", "window")
_LOWRANK = ("vecs", "lam", "alpha", "lam_w", "lam_s2", "alpha_s2", "buf", "buf_pos",
            "buf_fill")


def _t(x, device, dtype=None) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def _potential_from_numpy(d, device, window_multiplier, **static):
    f32, i32 = torch.float32, torch.int32

    def leaf(k, dtype=f32):
        return _t(d[f"potential.{k}"], device, dtype)

    def welford(cls, side, names):
        return cls(*(leaf(f"{side}.{k}") for k in names))

    mult = {} if window_multiplier is None else {"window_multiplier": float(window_multiplier)}
    if "potential.vecs" in d:
        lowrank = {k: leaf(k, i32 if k.startswith("buf_") else f32) for k in _LOWRANK}
        return QuadPotentialLowRankAdapt(
            var=leaf("var"), stds=leaf("stds"), inv_stds=leaf("inv_stds"),
            fg=welford(WelfordVariance, "fg", _WELFORD),
            bg=welford(WelfordVariance, "bg", _WELFORD),
            n_samples=leaf("n_samples", i32), window=leaf("window", i32), **lowrank,
            rank=int(lowrank["vecs"].shape[-1]), buffer_size=int(lowrank["buf"].shape[-2]),
            **mult, **static)
    if "potential.var" in d:
        return QuadPotentialDiagAdapt(
            var=leaf("var"), stds=leaf("stds"), inv_stds=leaf("inv_stds"),
            fg=welford(WelfordVariance, "fg", _WELFORD),
            bg=welford(WelfordVariance, "bg", _WELFORD),
            n_samples=leaf("n_samples", i32), window=leaf("window", i32), **mult)
    if "potential.fg.raw_cov" in d:
        return QuadPotentialFullAdapt(
            cov=leaf("cov"), chol=leaf("chol"), chol_failed=leaf("chol_failed", torch.bool),
            fg=welford(WelfordCovariance, "fg", _WELFORD_COV),
            bg=welford(WelfordCovariance, "bg", _WELFORD_COV),
            n_samples=leaf("n_samples", i32), prev_update=leaf("prev_update", i32),
            window=leaf("window", i32), **mult, **static)
    if "potential.cov" not in d:
        return QuadPotentialFullInv(chol=leaf("chol"))
    return QuadPotentialFull(cov=leaf("cov"), chol=leaf("chol"))


def chain_state_from_numpy(d: Dict[str, np.ndarray], device=None,
                           window_multiplier: Optional[float] = None,
                           **static) -> ChainState:
    """The port's chain-batched state from the JAX package's leaves.

    ``window_multiplier`` (default: the metric class's own) and
    ``static`` (``update_window``, ``regularize`` of the dense adaptation)
    set the metric's non-leaf fields; ``static`` also takes the low-rank
    metric's ``lam_clip``."""
    f32, i32 = torch.float32, torch.int32
    da = DualAverageState(*(_t(d[f"da.{k}"], device, i32 if k == "count" else f32)
                            for k in _DA))
    return ChainState(q=_t(d["q"], device, f32), q_grad=_t(d["q_grad"], device, f32),
                      logp=_t(d["logp"], device, f32),
                      potential=_potential_from_numpy(d, device, window_multiplier, **static),
                      da=da, iter_count=_t(d["iter_count"], device, i32))


def chain_state_to_numpy(state: ChainState) -> Dict[str, np.ndarray]:
    """The inverse of :func:`chain_state_from_numpy`."""
    pot = state.potential
    out = {"q": state.q, "q_grad": state.q_grad, "logp": state.logp,
           "iter_count": state.iter_count}
    if isinstance(pot, QuadPotentialLowRankAdapt):
        names, welford = _DIAG_ADAPT + _LOWRANK, _WELFORD
    elif isinstance(pot, QuadPotentialDiagAdapt):
        names, welford = _DIAG_ADAPT, _WELFORD
    elif isinstance(pot, QuadPotentialFullAdapt):
        names = ("cov", "chol", "chol_failed", "n_samples", "prev_update", "window")
        welford = _WELFORD_COV
    elif isinstance(pot, QuadPotentialFullInv):
        names, welford = ("chol",), ()
    else:
        names, welford = ("cov", "chol"), ()
    for k in names:
        out[f"potential.{k}"] = getattr(pot, k)
    for side in ("fg", "bg") if welford else ():
        for k in welford:
            out[f"potential.{side}.{k}"] = getattr(getattr(pot, side), k)
    for k in _DA:
        out[f"da.{k}"] = getattr(state.da, k)
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def spec_consts_from_numpy(consts: Sequence[np.ndarray], ndim: int,
                           device=None) -> Tuple[torch.Tensor, ...]:
    """A model spec's constants, cropped from the TPU kernel's padded
    width to ``ndim`` in every axis, as contiguous float32 tensors."""
    return tuple(
        _t(np.asarray(c)[tuple(slice(0, ndim) for _ in np.shape(c))], device,
           torch.float32).contiguous()
        for c in consts)


def _tree_tuple(cls, d: Dict[str, Optional[np.ndarray]], device):
    return cls(*(None if d.get(k) is None else _t(d[k], device, torch.float32)
                 for k in cls._fields))


def phase_state_from_numpy(d: Dict[str, np.ndarray], device=None) -> PhaseState:
    """The tree's ``PhaseState`` from the JAX one's fields (``q, p,
    q_grad, energy, logp``) as numpy arrays, e.g. ``{k: np.asarray(v) for
    k, v in state._asdict().items()}``."""
    return _tree_tuple(PhaseState, d, device)


def tree_node_from_numpy(d: Dict[str, Optional[np.ndarray]], device=None) -> TreeNode:
    """The tree's ``TreeNode`` from the JAX one's fields as numpy arrays;
    ``left_v``/``right_v`` may be None (a diagonal metric's nodes)."""
    return _tree_tuple(TreeNode, d, device)


def config_from_fields(fields: Dict[str, Any]) -> Union[NUTSConfig, HMCConfig]:
    """The port's config from a step method's config fields: an
    ``HMCConfig`` where they name ``path_length`` or ``max_steps``, else a
    ``NUTSConfig``. A field the port's config lacks raises ``ValueError``."""
    cls = HMCConfig if ({"path_length", "max_steps"} & set(fields)) else NUTSConfig
    known = {f.name for f in dataclasses.fields(cls)}
    extra = sorted(set(fields) - known)
    if extra:
        raise ValueError(f"{cls.__name__} has no field(s) {extra}")
    return cls(**fields)


def config_to_fields(config: Union[NUTSConfig, HMCConfig]) -> Dict[str, Any]:
    """The inverse of :func:`config_from_fields`."""
    return {f.name: getattr(config, f.name) for f in dataclasses.fields(config)}
