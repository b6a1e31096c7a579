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
  row-sum epilogue in one pass), for tensors on a CUDA device; its launch
  geometry (rows of the precision a stage of its TMA ring, stages,
  shared-memory bytes) is :func:`plan_quadform`'s.

:func:`quadform_logp_grad` picks by the tensors' device and never falls
back. The JAX function pads to its tiles; nothing here is padded.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from ..math import fp32_matmul
from ._tma import BARRIER_BYTES, MAX_SMEM_BYTES, MAX_STAGES

__all__ = ["quadform_logp_grad", "quadform_logp_grad_plain", "plan_quadform",
           "QuadformPlan", "CHAIN_TILE"]

# launch arguments, in the order of csrc/quadform_logp_grad.cu's enums
_PTRS = ("q", "prec", "logp", "grad")
_INTS = ("C", "n", "row_tile", "stages", "q_bulk", "smem_bytes")

_WARPS = 8
_ROW_TILE = 32  # rows of the precision a stage
# csrc/quadform_logp_grad.cu's kChainsPerWarp and kSplits: the 8 warps are
# 4 chain groups of 2 chains by 2 splits of the precision's rows, so 8
# chains a block and 128 blocks at 1024 chains; 1 x 1 and 2 x 1 were
# slower on the card (PERF.md, row 5)
_CHAINS_PER_WARP, _SPLITS = 2, 2
CHAIN_TILE = _CHAINS_PER_WARP * _WARPS // _SPLITS


class QuadformPlan(NamedTuple):
    """Launch geometry of ``csrc/quadform_logp_grad.cu``: ``grid`` blocks
    of ``CHAIN_TILE`` chains, the precision's rows coming ``row_tile`` rows
    a stage through a ring of ``stages``; ``q_bulk`` 1 where the block's q
    rows come by TMA (q 16-byte aligned), and the block's
    ``smem_bytes``."""
    row_tile: int
    stages: int
    q_bulk: int
    smem_bytes: int
    grid: int


def _round4(x: int) -> int:
    return (x + 3) & ~3


def _quadform_smem_bytes(kt: int, n: int, stages: int) -> int:
    """``QuadformLayout::bytes`` of the kernel: the barriers, then per
    stage ``kt`` rows of the precision, then the block's q rows and the
    second split's partial sums."""
    return BARRIER_BYTES + 4 * (stages * _round4(kt * n) + _round4(CHAIN_TILE * n)
                                + (_SPLITS - 1) * CHAIN_TILE * 32 * (-(-n // 32)))


@functools.lru_cache(maxsize=256)
def plan_quadform(C: int, n: int, q_aligned: bool = True) -> QuadformPlan:
    """The kernel's geometry for ``C`` chains of ``n`` dimensions: 32
    rows of the precision a stage (all ``n`` where ``n <= 32``) and as
    many stages as fit in ``MAX_SMEM_BYTES``, up to the tiles and 16;
    ``q_aligned``: whether q starts on a 16-byte boundary (its rows then
    come by TMA)."""
    if C < 1 or not 1 <= n <= 256:
        raise ValueError(f"no quadform kernel geometry for C={C}, n={n}")
    kt = min(n, _ROW_TILE)
    fixed = _quadform_smem_bytes(kt, n, 0)
    stages = min(-(-n // kt), MAX_STAGES,
                 (MAX_SMEM_BYTES - fixed) // (_quadform_smem_bytes(kt, n, 1) - fixed))
    return QuadformPlan(kt, stages, int(bool(q_aligned)), _quadform_smem_bytes(kt, n, stages),
                        -(-C // CHAIN_TILE))


def quadform_logp_grad_plain(q: torch.Tensor, prec: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(logp (C,), grad (C, n))`` in plain PyTorch, on any device."""
    g = -fp32_matmul(q, prec)
    return 0.5 * (q * g).sum(1), g


def _launch_kernel(q, prec):
    """The kernel on CUDA tensors."""
    from ._build import launch
    from .nuts_trajectory import MAX_KERNEL_NDIM_DENSE

    C, n = q.shape
    if n > MAX_KERNEL_NDIM_DENSE:
        raise ValueError(f"the quadform kernel takes n <= {MAX_KERNEL_NDIM_DENSE}, got {n}")
    q, prec = q.contiguous(), prec.contiguous()
    if prec.data_ptr() % 16:  # the TMA copies need 16-byte alignment: an aligned copy
        prec = prec.clone()
    plan = plan_quadform(C, n, q.data_ptr() % 16 == 0)
    buf = {"q": q, "prec": prec,
           "logp": torch.empty(C, dtype=torch.float32, device=q.device),
           "grad": torch.empty_like(q)}
    ints = {"C": C, "n": n, **plan._asdict()}
    launch("quadform_logp_grad", [buf[k].data_ptr() for k in _PTRS],
           [ints[k] for k in _INTS], [], q.device)
    quadform_logp_grad.launches += 1
    quadform_logp_grad.last_plan = plan
    return buf["logp"], buf["grad"]


def quadform_logp_grad(q: torch.Tensor, prec: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(logp (C,), grad (C, n))`` where the tensors lie: CPU tensors run
    :func:`quadform_logp_grad_plain`, CUDA tensors launch the kernel
    (``quadform_logp_grad.launches`` counts those launches,
    ``quadform_logp_grad.last_plan`` is the last launch's
    :func:`plan_quadform`) or raise."""
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
    return _launch_kernel(q, prec)


quadform_logp_grad.launches = 0
quadform_logp_grad.last_plan = None
