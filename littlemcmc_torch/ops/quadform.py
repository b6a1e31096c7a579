"""Batched zero-mean Gaussian log density and gradient from its precision.

Counterpart of ``littlemcmc_tpu/ops/gaussian_pallas.py::quadform_logp_grad``
(``:78-95``, kernel ``_kernel`` ``:40``): for ``q`` ``(C, n)`` and the
precision ``prec`` ``(n, n)``, ``grad = -(q @ prec)`` and ``logp = sum(q
* grad, 1) / 2``. Two implementations:

- :func:`quadform_logp_grad_plain`, plain PyTorch in full fp32
  (:func:`~littlemcmc_torch.math.fp32_matmul`), which runs for tensors on
  the CPU and is the yardstick the CUDA kernel is held against; it is also
  the correlated-Gaussian body of the plain trajectory ops
  (:func:`~littlemcmc_torch.ops.nuts_trajectory.body_logp_grad`);
- the CUDA kernel ``csrc/quadform_logp_grad.cu`` (the product and its
  row-sum epilogue in one pass), for tensors on a CUDA device.

:func:`quadform_logp_grad` picks by the tensors' device and never falls
back. The JAX function pads to its tiles; nothing here is padded.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..math import fp32_matmul

__all__ = ["quadform_logp_grad", "quadform_logp_grad_plain"]

# launch arguments, in the order of csrc/quadform_logp_grad.cu's enums
_PTRS = ("q", "prec", "logp", "grad")
_INTS = ("C", "n")


def quadform_logp_grad_plain(q: torch.Tensor, prec: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(logp (C,), grad (C, n))`` in plain PyTorch, on any device."""
    g = -fp32_matmul(q, prec)
    return 0.5 * (q * g).sum(1), g


def quadform_logp_grad(q: torch.Tensor, prec: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(logp (C,), grad (C, n))`` where the tensors lie: CPU tensors run
    :func:`quadform_logp_grad_plain`, CUDA tensors launch the kernel
    (``quadform_logp_grad.launches`` counts those launches) or raise."""
    C, n = q.shape
    if tuple(prec.shape) != (n, n):
        raise ValueError(f"prec must be ({n}, {n}), got {tuple(prec.shape)}")
    for name, t in (("q", q), ("prec", prec)):
        if t.device != q.device or t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 on {q.device}, got {t.dtype} "
                             f"on {t.device}")
    if q.device.type == "cpu":
        return quadform_logp_grad_plain(q, prec)
    if q.device.type != "cuda":
        raise RuntimeError(f"no quadform logp_grad implementation for device {q.device}")
    from ._build import launch
    from .nuts_trajectory import MAX_KERNEL_NDIM_DENSE

    if n > MAX_KERNEL_NDIM_DENSE:
        raise ValueError(f"the quadform kernel takes n <= {MAX_KERNEL_NDIM_DENSE}, got {n}")
    buf = {"q": q.contiguous(), "prec": prec.contiguous(),
           "logp": torch.empty(C, dtype=torch.float32, device=q.device),
           "grad": torch.empty_like(q)}
    ints = {"C": C, "n": n}
    launch("quadform_logp_grad", [buf[k].data_ptr() for k in _PTRS],
           [ints[k] for k in _INTS], [], q.device)
    quadform_logp_grad.launches += 1
    return buf["logp"], buf["grad"]


quadform_logp_grad.launches = 0
