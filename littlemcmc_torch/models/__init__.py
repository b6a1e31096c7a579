"""Model zoo (this slice: the Gaussian targets)."""

from .gaussian import CorrelatedGaussian, StandardNormal

__all__ = ["CorrelatedGaussian", "StandardNormal"]
