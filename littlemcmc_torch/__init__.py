"""littlemcmc_torch: the PyTorch and CUDA port of littlemcmc_tpu.

NUTS for many chains at once on one NVIDIA Hopper card. Each draw
launches one hand-written CUDA kernel that builds every chain's whole
trajectory with the model inlined (:mod:`littlemcmc_torch.ops`). Entry
points run on the CUDA device unless the caller passes ``device="cpu"``,
which runs the kernels' plain PyTorch versions.

This package imports PyTorch, numpy and the standard library only.
"""

from .base import ChainState, NUTSConfig
from .exceptions import IntegrationError, ParallelSamplingError, SamplingError
from .quadpotential import QuadPotentialDiag, QuadPotentialDiagAdapt
from .report import SamplerWarning, WarningType
from .sampling import NUTS, init_nuts, sample

__all__ = [
    "sample",
    "init_nuts",
    "NUTS",
    "NUTSConfig",
    "ChainState",
    "QuadPotentialDiag",
    "QuadPotentialDiagAdapt",
    "SamplerWarning",
    "WarningType",
    "SamplingError",
    "IntegrationError",
    "ParallelSamplingError",
]
