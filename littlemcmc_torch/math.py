"""Log-space math utilities (counterpart of ``littlemcmc_tpu/math.py:17-68``).

Stochastic primitives take an explicit ``torch.Generator``. ``dot_f32x3``
is not ported: it splits an fp32 product into bf16 passes for the TPU's
matrix unit, and on Hopper the port multiplies in plain fp32.
"""

from __future__ import annotations

import torch

__all__ = ["logbern", "log1mexp", "logdiffexp", "round_up", "fp32_matmul"]


def fp32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full float32, whatever ``torch.set_float32_matmul_precision``
    (or ``allow_tf32``) says: the products feed energies and U-turn
    decisions. The caller's setting is restored."""
    prev = torch.get_float32_matmul_precision()
    if prev == "highest":
        return a @ b
    torch.set_float32_matmul_precision("highest")
    try:
        return a @ b
    finally:
        torch.set_float32_matmul_precision(prev)


def logbern(log_p: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """Bernoulli trial in log space: ``True`` with probability ``exp(log_p)``.

    A NaN ``log_p`` yields ``False`` (the comparison is false), as in the
    JAX package.
    """
    log_p = torch.as_tensor(log_p, dtype=torch.float32)
    u = torch.rand(log_p.shape, generator=generator, dtype=log_p.dtype,
                   device=log_p.device)
    return torch.log(u) < log_p


def log1mexp(x) -> torch.Tensor:
    """``log(1 - exp(-x))`` for ``x > 0``, with the switch at 0.683
    (Maechler's note; reference ``math.py:28-35``)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    small = x < 0.683
    safe_small = torch.where(small, x, torch.ones_like(x))
    safe_large = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, torch.log(-torch.expm1(-safe_small)),
                       torch.log1p(-torch.exp(-safe_large)))


def logdiffexp(a, b) -> torch.Tensor:
    """``log(exp(a) - exp(b))`` for ``a > b``."""
    a = torch.as_tensor(a, dtype=torch.float32)
    return a + log1mexp(a - torch.as_tensor(b, dtype=torch.float32))


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to the next multiple of ``m``."""
    return ((x + m - 1) // m) * m
