"""littlemcmc_torch: the PyTorch and CUDA port of littlemcmc_tpu.

NUTS and classic HMC for many chains at once on one NVIDIA Hopper card,
through hand-written CUDA kernels that run every chain's whole trajectory
with the model inlined, one draw per launch or a chunk of draws per launch
(:mod:`littlemcmc_torch.ops`), or, for a model without a kernel body, on
the tensor-op NUTS tree (:func:`littlemcmc_torch.nuts.run_nuts_tree`). Entry
points run on the CUDA device unless the caller passes ``device="cpu"``,
which runs the kernels' plain PyTorch versions.

This package imports PyTorch, numpy and the standard library only.
"""

from .base import ChainState, HMCConfig, NUTSConfig
from .exceptions import IntegrationError, ParallelSamplingError, SamplingError
from .quadpotential import QuadPotentialDiag, QuadPotentialDiagAdapt, QuadPotentialLowRankAdapt
from .report import SamplerWarning, WarningType
from .sampling import NUTS, HamiltonianMC, init_nuts, sample

__all__ = [
    "sample",
    "init_nuts",
    "NUTS",
    "HamiltonianMC",
    "NUTSConfig",
    "HMCConfig",
    "ChainState",
    "QuadPotentialDiag",
    "QuadPotentialDiagAdapt",
    "QuadPotentialLowRankAdapt",
    "SamplerWarning",
    "WarningType",
    "SamplingError",
    "IntegrationError",
    "ParallelSamplingError",
]
