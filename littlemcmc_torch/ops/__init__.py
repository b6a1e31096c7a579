"""Hand-written CUDA kernels and their plain PyTorch versions.

Importing this package builds nothing: the kernels compile with ``nvcc``
at their first launch (:mod:`littlemcmc_torch.ops._build`).
"""

from .nuts_trajectory import (DEFAULT_CHAIN_BLOCK, TrajectorySpec, trajectory,
                              trajectory_plain)

__all__ = ["DEFAULT_CHAIN_BLOCK", "TrajectorySpec", "trajectory", "trajectory_plain"]
