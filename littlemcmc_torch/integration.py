"""Symplectic integration over chain-batched phase-space states.

Counterpart of ``littlemcmc_tpu/integration.py:34-110``. Every function
works on one chain (``(n,)`` tensors, scalar step) or on a batch
(``(C, n)`` tensors, ``(C,)`` steps): reductions run over the last axis.
Non-finite values propagate; the samplers' divergence checks catch them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

__all__ = ["IntegratorState", "compute_state", "recompute_with_momentum",
           "leapfrog", "INTEGRATOR_COEFFS"]

# Palindromic splitting coefficients: kick weights b (stages + 1) and drift
# weights a (stages); one model evaluation per drift. "leapfrog" is the
# reference's velocity Verlet; the two- and three-stage schemes are the
# minimal-norm splittings of Blanes, Casas & Sanz-Serna (2014).
_LAMBDA_2 = 0.1931833275037836
_A1_3 = 0.29619504261126
_B1_3 = 0.11888010966548
INTEGRATOR_COEFFS = {
    "leapfrog": ((0.5, 0.5), (1.0,)),
    "two_stage": ((_LAMBDA_2, 1.0 - 2.0 * _LAMBDA_2, _LAMBDA_2), (0.5, 0.5)),
    "three_stage": (
        (_B1_3, 0.5 - _B1_3, 0.5 - _B1_3, _B1_3),
        (_A1_3, 1.0 - 2.0 * _A1_3, _A1_3),
    ),
}

LogpGradFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


class IntegratorState(NamedTuple):
    """Phase-space point (reference ``integration.py:25``)."""

    q: torch.Tensor
    p: torch.Tensor
    v: torch.Tensor  # velocity = M^{-1} p
    q_grad: torch.Tensor
    energy: torch.Tensor  # kinetic - logp
    model_logp: torch.Tensor


def _column(eps, like: torch.Tensor) -> torch.Tensor:
    """A per-chain ``(C,)`` step as a ``(C, 1)`` column; scalars pass."""
    eps = torch.as_tensor(eps, dtype=like.dtype, device=like.device)
    return eps[..., None] if eps.ndim == 1 and like.ndim == 2 else eps


def compute_state(potential, logp_grad_fn: LogpGradFn, q, p) -> IntegratorState:
    """Evaluate the Hamiltonian at ``(q, p)`` (reference ``integration.py:52-66``)."""
    logp, grad = logp_grad_fn(q)
    v = potential.velocity(p)
    return IntegratorState(q, p, v, grad, potential.kinetic(p, v) - logp, logp)


def recompute_with_momentum(potential, q, q_grad, logp, p) -> IntegratorState:
    """Trajectory start from a cached ``(logp, grad)`` and a fresh momentum."""
    v = potential.velocity(p)
    return IntegratorState(q, p, v, q_grad, potential.kinetic(p, v) - logp, logp)


def leapfrog(potential, logp_grad_fn: LogpGradFn, epsilon,
             state: IntegratorState, scheme: str = "leapfrog") -> IntegratorState:
    """One symplectic step (default: kick-drift-kick leapfrog).

    The returned velocity is ``M^{-1} p_final``, as in the reference
    (``integration.py:100-121``) and the JAX package.
    """
    b, a = INTEGRATOR_COEFFS[scheme]
    eps = _column(epsilon, state.q)
    p = state.p + (b[0] * eps) * state.q_grad
    q, logp, grad = state.q, state.model_logp, state.q_grad
    for i, ai in enumerate(a):
        q = q + (ai * eps) * potential.velocity(p)
        logp, grad = logp_grad_fn(q)
        p = p + (b[i + 1] * eps) * grad
    v = potential.velocity(p)
    return IntegratorState(q, p, v, grad, potential.kinetic(p, v) - logp, logp)
