"""One classic-HMC transition per chain: the HMC trajectory op.

Counterpart of ``littlemcmc_tpu/ops/hmc_trajectory_pallas.py::
build_hmc_trajectory_op`` (``pallas_call`` at ``:273``; body
``run_hmc_trajectory_values`` ``:58-110``) with ``pack=1``, diag metric.
One call integrates every chain's trajectory with the model inlined and
Metropolis-accepts it:

- the start energy ``E0`` from the start momentum;
- ``n_steps[c]`` symplectic steps for chain ``c`` and no more (a chain
  that diverges integrates on to its count, as in the JAX body);
- the end energy, ``dE = E0 - E`` with NaN read as ``-inf``, divergence on
  a non-finite ``E`` or ``|dE| > Emax``, ``accept = min(1, exp dE)``;
- one uniform per chain: the selected state is the end state where the
  chain did not diverge and ``u < accept``, else the start.

Two implementations compute the same function: :func:`hmc_trajectory_plain`,
plain PyTorch, for CPU tensors and as the yardstick; and the CUDA kernel
``csrc/hmc_trajectory.cu`` for CUDA tensors. :func:`hmc_trajectory` picks
by the tensors' device and never falls back. The kernel integrates body 1
(the correlated Gaussian) on the block HMC transition
(:func:`.nuts_trajectory.runs_hmc_block_transition`): each thread block's
chains in lockstep to their longest count, each frozen past its own, as
the plain version's loop runs every chain to the longest count with the
steps past a chain's own masked; the same bits as one warp a chain.

Randomness: the accept uniform is call 1 of the JAX kernel's per-chain
counter stream (``:133-155``), salted by the logical chain block ``block``
and the chain's ``row`` in it (:func:`counter_salt`). The chain block is
the JAX op's (``resolve_chain_block``, default
:data:`DEFAULT_HMC_CHAIN_BLOCK`), not the CUDA kernel's thread block, so the
plain version, the kernel and ``build_hmc_trajectory_op(interpret=True,
chain_block=CB)`` draw the same numbers.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..integration import INTEGRATOR_COEFFS
from .nuts_trajectory import (kernel_library, BODY_IDS, MAX_KERNEL_NDIM_DENSE, TrajectorySpec, _rowdot,
                              _seed_words, body_logp_grad, counter_salt, counter_uniform,
                              int32_bits, metric_velocity, resolve_chain_block)

__all__ = ["hmc_trajectory", "hmc_trajectory_plain", "hmc_transition",
           "DEFAULT_HMC_CHAIN_BLOCK", "OUT_KEYS"]

# the JAX per-draw HMC kernel's chain block at pack 1 (hmc.py:217-218)
DEFAULT_HMC_CHAIN_BLOCK = 512

# outputs, each (C,) besides q and grad (C, n)
OUT_KEYS = ("q", "grad", "logp", "logp_end", "energy", "energy_change", "accept_stat",
            "accepted", "diverging")
_OUT_F32 = ("logp", "logp_end", "energy", "energy_change", "accept_stat")
# the kernel's pointer arguments, in the order of csrc/hmc_trajectory.cu
_PTRS = ("q", "p", "grad", "var", "logp_in", "eps", "n_steps", "consts",
         "q_out", "grad_out") + _OUT_F32 + ("accepted", "diverging")


def hmc_transition(model: Callable, vel: Callable, coeffs, Emax: float, q0, p0, g0, lp0,
                   eps, n_steps, u) -> Dict[str, torch.Tensor]:
    """``run_hmc_trajectory_values`` (``hmc_trajectory_pallas.py:58-110``)
    on tensors: ``n_steps[c]`` steps for chain ``c`` (masked past its
    count) and the Metropolis accept against the uniforms ``u``. The fused
    op's plain version runs it too."""
    b_coef, a_coef = coeffs
    epsb = eps[:, None]
    E0 = 0.5 * _rowdot(p0, vel(p0)) - lp0
    q, p, g, lp = q0, p0, g0, lp0
    for t in range(int(n_steps.max())):
        pn = p + (b_coef[0] * epsb) * g
        qn, gn, lpn = q, g, lp
        for i, ai in enumerate(a_coef):
            qn = qn + (ai * epsb) * vel(pn)
            lpn, gn = model(qn)
            pn = pn + (b_coef[i + 1] * epsb) * gn
        live = t < n_steps
        lb = live[:, None]
        q, p, g = torch.where(lb, qn, q), torch.where(lb, pn, p), torch.where(lb, gn, g)
        lp = torch.where(live, lpn, lp)
    en = 0.5 * _rowdot(p, vel(p)) - lp
    dE = E0 - en  # reference: energy_change = start - end (hmc.py:158)
    dE = torch.where(torch.isnan(dE), torch.full_like(dE, float("-inf")), dE)
    div = ~torch.isfinite(en) | (dE.abs() > Emax)
    acc = torch.clamp(torch.exp(dE), max=1.0)
    accepted = ~div & (u < acc)
    ac = accepted[:, None]
    return dict(q=torch.where(ac, q, q0), grad=torch.where(ac, g, g0),
                logp=torch.where(accepted, lp, lp0), logp_end=lp, energy=en,
                energy_change=dE, accept_stat=acc, accepted=accepted, diverging=div)


def _chain_salts(seed0: int, seed1: int, C: int, cb: int, device) -> torch.Tensor:
    """Every chain's counter-stream salt: chain ``c`` is row ``c % cb`` of
    chain block ``c // cb``."""
    return torch.cat([counter_salt(seed0, seed1, blk, cb, device) for blk in range(C // cb)])


# --------------------------------------------------------------------------
# The plain version
# --------------------------------------------------------------------------

def hmc_trajectory_plain(q, p, grad, logp, eps, n_steps, var, seed, *,
                         spec: TrajectorySpec, Emax: float,
                         chain_block: int = DEFAULT_HMC_CHAIN_BLOCK,
                         integrator: str = "leapfrog") -> Dict[str, torch.Tensor]:
    """The plain PyTorch transition, every chain at once, on any device."""
    C = q.shape[0]
    cb = resolve_chain_block(C, chain_block)
    seed0, seed1 = _seed_words(seed)
    u = counter_uniform(_chain_salts(seed0, seed1, C, cb, q.device), 1)
    return hmc_transition(lambda x: body_logp_grad(spec, x), metric_velocity(var, "diag"),
                          INTEGRATOR_COEFFS[integrator], float(Emax), q, p, grad, logp,
                          eps, n_steps, u)


# --------------------------------------------------------------------------
# The CUDA kernel's wrapper
# --------------------------------------------------------------------------

def _check_inputs(spec, q, p, grad, logp, eps, n_steps, var):
    C, n = q.shape
    if n != spec.ndim:
        raise ValueError(f"q has {n} columns but the model has {spec.ndim}")
    dev = q.device
    for name, t, shape, dtype in (
            ("q", q, (C, n), torch.float32), ("p", p, (C, n), torch.float32),
            ("grad", grad, (C, n), torch.float32), ("var", var, (C, n), torch.float32),
            ("logp", logp, (C,), torch.float32), ("eps", eps, (C,), torch.float32),
            ("n_steps", n_steps, (C,), torch.int32)):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    for c in spec.consts:
        if c.device != dev or c.dtype != torch.float32 or not c.is_contiguous():
            raise ValueError("model constants must be contiguous float32 on "
                             f"{dev}; got {c.dtype} on {c.device}")


def _launch_kernel(q, p, grad, logp, eps, n_steps, var, seed, *, spec, Emax, chain_block,
                   integrator):
    from ._build import launch

    C, n = q.shape
    if spec.body in ("correlated_gaussian", "logistic") and n > MAX_KERNEL_NDIM_DENSE:
        raise ValueError(f"the {spec.body} body takes n <= "
                         f"{MAX_KERNEL_NDIM_DENSE}, got {n}")
    cb = resolve_chain_block(C, chain_block)
    seed0, seed1 = _seed_words(seed)
    b_coef, a_coef = INTEGRATOR_COEFFS[integrator]
    dev = q.device
    buf = {"q": q.contiguous(), "p": p.contiguous(), "grad": grad.contiguous(),
           "var": var.contiguous(), "logp_in": logp.contiguous(), "eps": eps.contiguous(),
           "n_steps": n_steps.contiguous(),
           "consts": spec.kernel_consts,
           "q_out": torch.empty_like(q), "grad_out": torch.empty_like(q)}
    for k in _OUT_F32:
        buf[k] = torch.empty(C, dtype=torch.float32, device=dev)
    for k in ("accepted", "diverging"):
        buf[k] = torch.empty(C, dtype=torch.bool, device=dev)
    launch("hmc_trajectory",
           [buf[k].data_ptr() if buf[k] is not None else None for k in _PTRS],
           # C n cb n_stages body seed0 seed1 rows
           [C, n, cb, len(a_coef), BODY_IDS[spec.body], int32_bits(seed0), int32_bits(seed1),
            spec.rows],
           # Emax b0 b1 b2 b3 a0 a1 a2
           [float(Emax)] + list(b_coef) + [0.0] * (4 - len(b_coef))
           + list(a_coef) + [0.0] * (3 - len(a_coef)), dev,
           lib=kernel_library("hmc_trajectory", spec, dev, C))
    hmc_trajectory.launches += 1
    out = {"q": buf["q_out"], "grad": buf["grad_out"]}
    out.update({k: buf[k] for k in _OUT_F32 + ("accepted", "diverging")})
    return out


def hmc_trajectory(q, p, grad, logp, eps, n_steps, var, seed, *, spec: TrajectorySpec,
                   Emax: float, chain_block: int = DEFAULT_HMC_CHAIN_BLOCK,
                   integrator: str = "leapfrog") -> Dict[str, torch.Tensor]:
    """One HMC transition for every chain, where the tensors lie.

    Inputs: ``q, p, grad`` ``(C, n)`` float32, ``var`` the ``(C, n)``
    inverse-mass diagonals, ``logp, eps`` ``(C,)`` float32, ``n_steps``
    ``(C,)`` int32 (at least 1), ``seed`` an int or two int32 words.
    Returns the JAX op's dict (``hmc_trajectory_pallas.py:298-308``): the
    selected ``q``, ``grad`` and ``logp``, the end state's ``logp_end`` and
    ``energy``, ``energy_change``, ``accept_stat``, and the bool flags
    ``accepted`` and ``diverging``.

    CPU tensors run :func:`hmc_trajectory_plain`; CUDA tensors launch the
    kernel (``hmc_trajectory.launches`` counts those launches) or raise.
    """
    _check_inputs(spec, q, p, grad, logp, eps, n_steps, var)
    kw = dict(spec=spec, Emax=Emax, chain_block=chain_block, integrator=integrator)
    if q.device.type == "cpu":
        return hmc_trajectory_plain(q, p, grad, logp, eps, n_steps, var, seed, **kw)
    if q.device.type == "cuda":
        return _launch_kernel(q, p, grad, logp, eps, n_steps, var, seed, **kw)
    raise RuntimeError(f"no HMC trajectory implementation for device {q.device}")


hmc_trajectory.launches = 0
