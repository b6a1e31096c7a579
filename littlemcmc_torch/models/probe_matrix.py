"""The JAX package's autospec probe matrix as torch models.

Nine small models of ``tests/test_autospec.py:309-350`` on the same numpy
data, written as a user would write them in torch. They cover the op set
that a generated body must lower (matrix-vector products, log-sigmoid,
clamp, log1p, abs, slicing, where, a gather and its segment sum). The
tests hold their generated bodies against the JAX package's, and
``chip_smoke.py`` probes them on the card.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

__all__ = ["autospec_matrix"]


def autospec_matrix(device) -> Dict[str, Callable]:
    """name -> logp of one chain's ``(3,)`` position, its data on ``device``."""
    n = 3
    X = torch.from_numpy(np.random.RandomState(0).randn(50, n).astype(np.float32)).to(device)
    y = torch.from_numpy((np.random.RandomState(1).rand(50) > 0.5).astype(np.float32)
                         ).to(device)
    G = torch.from_numpy(np.random.RandomState(2).randint(0, n, 50)).to(device)
    F = torch.nn.functional

    def segsum(v):
        return torch.zeros(n, device=device).index_add(0, G, v)

    return {
        "gaussian_quadratic": lambda b: -0.5 * torch.sum((X @ b) ** 2),
        "logistic": lambda b: torch.sum(y * F.logsigmoid(X @ b)
                                        + (1 - y) * F.logsigmoid(-(X @ b)))
        - 0.5 * torch.sum(b ** 2),
        "poisson_loglink": lambda b: torch.sum(y * (X @ b)
                                               - torch.exp(torch.clamp(X @ b, -10, 10))),
        "student_t": lambda b: -torch.sum(2.0 * torch.log1p((X @ b) ** 2 / 4.0)),
        "laplace_prior": lambda b: torch.sum(y * (X @ b)) - torch.sum(torch.abs(b))
        - 0.05 * torch.sum((X @ b) ** 2),
        "hierarchical_ncp": lambda b: -0.5 * b[0] ** 2
        - 0.5 * torch.sum((b[1:] - b[0]) ** 2 * torch.exp(-b[0])),
        "softplus_link": lambda b: -torch.sum((y - F.softplus(X @ b)) ** 2)
        - 0.5 * torch.sum(b ** 2),
        "piecewise": lambda b: torch.sum(torch.where(X @ b > 0, -(X @ b) ** 2, X @ b)) * 0.1,
        "hierarchical_gather": lambda b: (-0.5 * torch.sum((y - b[G]) ** 2)
                                          - 0.1 * torch.sum(segsum((y - b[G]) ** 2))
                                          - 0.5 * torch.sum(b ** 2)),
    }
