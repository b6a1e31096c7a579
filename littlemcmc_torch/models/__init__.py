"""Model zoo: the Gaussian targets (standard, correlated, spiked), eight schools,
logistic regression, Neal's funnel (centred and non-centred) and the
hierarchical regression."""

from .eight_schools import EightSchools
from .funnel import NealsFunnel, NonCenteredFunnel
from .gaussian import CorrelatedGaussian, SpikedGaussian, StandardNormal
from .hierarchical import HierarchicalRegression
from .logistic import LogisticRegression, german_credit_synthetic

__all__ = ["CorrelatedGaussian", "EightSchools", "HierarchicalRegression", "LogisticRegression",
           "NealsFunnel", "NonCenteredFunnel", "SpikedGaussian", "StandardNormal",
           "german_credit_synthetic"]
