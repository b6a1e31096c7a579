"""Model zoo: the Gaussian targets (standard, correlated, spiked), eight schools and
logistic regression."""

from .eight_schools import EightSchools
from .gaussian import CorrelatedGaussian, SpikedGaussian, StandardNormal
from .logistic import LogisticRegression, german_credit_synthetic

__all__ = ["CorrelatedGaussian", "EightSchools", "LogisticRegression", "SpikedGaussian",
           "StandardNormal", "german_credit_synthetic"]
