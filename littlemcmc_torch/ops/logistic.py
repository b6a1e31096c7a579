"""Batched logistic-regression log density and gradient.

Counterpart of ``littlemcmc_tpu/ops/logistic_pallas.py::
make_logistic_logp_grad`` (``:94-130``, kernel ``_kernel`` ``:41``). For
``q`` ``(C, n)``, the design ``xb`` ``(N, n)`` (intercept folded in), the
responses ``y`` ``(N,)`` and the prior precision ``prior_prec``
``(1,)``::

    logits = q xb^T
    logp = sum(y * logits - softplus(logits), 1) - prior_prec * sum(q * q, 1) / 2
    grad = (y - sigmoid(logits)) xb - prior_prec * q

with the stable softplus of ``jax.nn.softplus``. Two implementations:

- :func:`logistic_logp_grad_plain`, plain PyTorch, which runs for tensors
  on the CPU and is the yardstick the CUDA kernel is held against; it is
  also the logistic body of the plain trajectory ops
  (:func:`~littlemcmc_torch.ops.nuts_trajectory.body_logp_grad`);
- the CUDA kernel ``csrc/logistic_logp_grad.cu``, which keeps the
  ``(C, N)`` logits on chip, for tensors on a CUDA device.

:func:`logistic_logp_grad` picks by the tensors' device and never falls
back. The JAX function pads ``N`` and ``n`` to its tiles and subtracts the
padded rows' ``(N_pad - N) log 2`` afterwards; nothing here is padded, so
only the results agree.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..math import fp32_matmul

__all__ = ["logistic_logp_grad", "logistic_logp_grad_plain", "pack_logistic"]

# launch arguments, in the order of csrc/logistic_logp_grad.cu's enums
_PTRS = ("q", "consts", "logp", "grad")
_INTS = ("C", "n", "rows")


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``'s form, ``logaddexp(x, 0)``: ``max(x, 0) +
    log1p(exp(-|x|))`` (``torch.nn.functional.softplus`` switches to ``x``
    above a threshold instead)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def logistic_logp_grad_plain(q: torch.Tensor, xb: torch.Tensor, y: torch.Tensor,
                             prior_prec: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(logp (C,), grad (C, n))`` in plain PyTorch, on any device, the
    products in full fp32."""
    logits = fp32_matmul(q, xb.T)
    loglik = (y * logits - _softplus(logits)).sum(1)
    logprior = -0.5 * prior_prec * (q * q).sum(1)
    grad = fp32_matmul(y - torch.sigmoid(logits), xb) - prior_prec * q
    return loglik + logprior, grad


def pack_logistic(xb: torch.Tensor, y: torch.Tensor, prior_prec: torch.Tensor) -> torch.Tensor:
    """The kernels' layout of the constants, one contiguous buffer: ``xb``
    at the odd row stride ``n | 1`` (a zero column appended where ``n`` is
    even; lanes reading one row each then hit 32 different banks of
    shared memory), then ``y``, then ``prior_prec``
    (``csrc/nuts_transition.cuh::body_floats``)."""
    rows, n = xb.shape
    if n % 2 == 0:
        xb = torch.cat([xb, xb.new_zeros(rows, 1)], 1)
    return torch.cat([xb.reshape(-1), y, prior_prec]).contiguous()


def _check_inputs(q, xb, y, prior_prec):
    if q.ndim != 2 or xb.ndim != 2 or q.shape[1] != xb.shape[1]:
        raise ValueError(f"q (C, n) and xb (N, n) must share n; got {tuple(q.shape)} "
                         f"and {tuple(xb.shape)}")
    for name, t, shape in (("y", y, (xb.shape[0],)), ("prior_prec", prior_prec, (1,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    for name, t in (("q", q), ("xb", xb), ("y", y), ("prior_prec", prior_prec)):
        if t.device != q.device or t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 on {q.device}, got {t.dtype} "
                             f"on {t.device}")


def _launch_kernel(q, consts, rows):
    from ._build import launch
    from .nuts_trajectory import MAX_KERNEL_NDIM_DENSE

    C, n = q.shape
    if n > MAX_KERNEL_NDIM_DENSE:
        raise ValueError(f"the logistic kernel takes n <= {MAX_KERNEL_NDIM_DENSE}, got {n}")
    buf = {"q": q.contiguous(), "consts": consts,
           "logp": torch.empty(C, dtype=torch.float32, device=q.device),
           "grad": torch.empty_like(q)}
    ints = {"C": C, "n": n, "rows": rows}
    launch("logistic_logp_grad", [buf[k].data_ptr() for k in _PTRS],
           [ints[k] for k in _INTS], [], q.device)
    logistic_logp_grad.launches += 1
    return buf["logp"], buf["grad"]


def logistic_logp_grad(q: torch.Tensor, xb: torch.Tensor, y: torch.Tensor,
                       prior_prec: torch.Tensor, packed: torch.Tensor = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(logp (C,), grad (C, n))`` of the logistic regression, where the
    tensors lie: CPU tensors run :func:`logistic_logp_grad_plain`, CUDA
    tensors launch the kernel (``logistic_logp_grad.launches`` counts those
    launches) or raise. ``packed``: the constants in the kernel's layout
    (:func:`pack_logistic`) when the caller keeps them
    (``TrajectorySpec.kernel_consts``); else they are packed here."""
    _check_inputs(q, xb, y, prior_prec)
    if q.device.type == "cpu":
        return logistic_logp_grad_plain(q, xb, y, prior_prec)
    if q.device.type == "cuda":
        if packed is None:
            packed = pack_logistic(xb, y, prior_prec)
        return _launch_kernel(q, packed, xb.shape[0])
    raise RuntimeError(f"no logistic logp_grad implementation for device {q.device}")


logistic_logp_grad.launches = 0
