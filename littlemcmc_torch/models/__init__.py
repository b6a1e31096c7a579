"""Model zoo: the Gaussian targets, eight schools and logistic regression."""

from .eight_schools import EightSchools
from .gaussian import CorrelatedGaussian, StandardNormal
from .logistic import LogisticRegression, german_credit_synthetic

__all__ = ["CorrelatedGaussian", "EightSchools", "LogisticRegression", "StandardNormal",
           "german_credit_synthetic"]
