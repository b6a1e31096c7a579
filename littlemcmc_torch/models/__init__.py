"""Model zoo: the Gaussian targets and eight schools."""

from .eight_schools import EightSchools
from .gaussian import CorrelatedGaussian, StandardNormal

__all__ = ["CorrelatedGaussian", "EightSchools", "StandardNormal"]
