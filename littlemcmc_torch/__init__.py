"""littlemcmc_torch: the PyTorch and CUDA port of littlemcmc_tpu.

NUTS and classic HMC for many chains at once on one NVIDIA Hopper card,
through hand-written CUDA kernels that run every chain's whole trajectory
with the model inlined, one draw per launch or a chunk of draws per launch
(:mod:`littlemcmc_torch.ops`), or, for a model without a kernel body, on
the tensor-op NUTS tree (:func:`littlemcmc_torch.nuts.run_nuts_tree`). Entry
points run on the CUDA device unless the caller passes ``device="cpu"``,
which runs the kernels' plain PyTorch versions.

This package imports PyTorch, numpy and the standard library only. Its
public names are the JAX package's (``littlemcmc_tpu/__init__.py:28-50``)
but for the Pallas model spec and ``from_torch_callable``, which have no
counterpart here.
"""

from . import models, utils
from .base import ChainState, HMCConfig, NUTSConfig, init_chain_state
from .exceptions import IntegrationError, ParallelSamplingError, SamplingError
from .hmc import HMCInfo, build_hmc_kernel
from .model import as_logp_grad, from_logp_fn, from_numpy_callable
from .nuts import NUTSInfo, build_nuts_kernel
from .quadpotential import (PositiveDefiniteError, QuadPotentialDiag, QuadPotentialDiagAdapt,
                            QuadPotentialFull, QuadPotentialFullAdapt, QuadPotentialFullInv,
                            QuadPotentialLowRankAdapt, isquadpotential, quad_potential)
from .report import SamplerWarning, WarningType, warnings_from_stats
from .sampling import NUTS, HamiltonianMC, init_nuts, sample

__all__ = [
    "sample",
    "init_nuts",
    "NUTS",
    "HamiltonianMC",
    "quad_potential",
    "isquadpotential",
    "PositiveDefiniteError",
    "QuadPotentialDiag",
    "QuadPotentialFull",
    "QuadPotentialFullInv",
    "QuadPotentialDiagAdapt",
    "QuadPotentialFullAdapt",
    "QuadPotentialLowRankAdapt",
    "NUTSConfig",
    "HMCConfig",
    "ChainState",
    "init_chain_state",
    "build_nuts_kernel",
    "build_hmc_kernel",
    "NUTSInfo",
    "HMCInfo",
    "as_logp_grad",
    "from_logp_fn",
    "from_numpy_callable",
    "SamplerWarning",
    "WarningType",
    "warnings_from_stats",
    "SamplingError",
    "IntegrationError",
    "ParallelSamplingError",
    "models",
    "utils",
]
