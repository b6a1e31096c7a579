"""Carry sampler state across from the JAX package, as numpy arrays.

The JAX package's chain-batched ``ChainState`` (``littlemcmc_tpu/base.py``)
flattens to named numpy arrays; the names are the attribute paths of its
leaves, joined with dots::

    q, q_grad, logp, iter_count,
    potential.var, potential.stds, potential.inv_stds,
    potential.fg.{w_sum, w_sum2, mean, raw_var}, potential.bg.{...},
    potential.n_samples, potential.window,
    da.{log_step, log_bar, hbar, count, mu}

(``rng_key`` is ignored: the port draws from ``torch.Generator`` objects.)
:func:`chain_state_from_numpy` builds the port's :class:`ChainState` with a
``QuadPotentialDiagAdapt`` from such a dict, and
:func:`chain_state_to_numpy` is its inverse. :func:`spec_consts_from_numpy`
turns a JAX model spec's constants, zero-padded to the TPU kernel's lane
width, into the port's unpadded ones.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .base import ChainState
from .quadpotential import QuadPotentialDiagAdapt, WelfordVariance
from .step_sizes import DualAverageState

__all__ = ["chain_state_from_numpy", "chain_state_to_numpy", "spec_consts_from_numpy"]

_WELFORD = ("w_sum", "w_sum2", "mean", "raw_var")
_DA = ("log_step", "log_bar", "hbar", "count", "mu")


def _t(x, device, dtype=None) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def chain_state_from_numpy(d: Dict[str, np.ndarray], device=None,
                           window_multiplier: float = 1.0) -> ChainState:
    """The port's chain-batched state from the JAX package's leaves."""
    f32, i32 = torch.float32, torch.int32

    def welford(prefix):
        return WelfordVariance(*(_t(d[f"{prefix}.{k}"], device, f32) for k in _WELFORD))

    pot = QuadPotentialDiagAdapt(
        var=_t(d["potential.var"], device, f32),
        stds=_t(d["potential.stds"], device, f32),
        inv_stds=_t(d["potential.inv_stds"], device, f32),
        fg=welford("potential.fg"), bg=welford("potential.bg"),
        n_samples=_t(d["potential.n_samples"], device, i32),
        window=_t(d["potential.window"], device, i32),
        window_multiplier=float(window_multiplier))
    da = DualAverageState(*(_t(d[f"da.{k}"], device, i32 if k == "count" else f32)
                            for k in _DA))
    return ChainState(q=_t(d["q"], device, f32), q_grad=_t(d["q_grad"], device, f32),
                      logp=_t(d["logp"], device, f32), potential=pot, da=da,
                      iter_count=_t(d["iter_count"], device, i32))


def chain_state_to_numpy(state: ChainState) -> Dict[str, np.ndarray]:
    """The inverse of :func:`chain_state_from_numpy`."""
    pot = state.potential
    out = {"q": state.q, "q_grad": state.q_grad, "logp": state.logp,
           "iter_count": state.iter_count, "potential.var": pot.var,
           "potential.stds": pot.stds, "potential.inv_stds": pot.inv_stds,
           "potential.n_samples": pot.n_samples, "potential.window": pot.window}
    for side in ("fg", "bg"):
        for k in _WELFORD:
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
