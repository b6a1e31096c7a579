"""Model zoo: the Gaussian targets (standard, correlated, spiked), eight schools,
logistic and linear regression, Neal's funnel (centred and non-centred), the
hierarchical regression and stochastic volatility."""

from .eight_schools import EightSchools
from .funnel import NealsFunnel, NonCenteredFunnel
from .gaussian import CorrelatedGaussian, SpikedGaussian, StandardNormal
from .hierarchical import HierarchicalRegression
from .linear import LinearRegression
from .logistic import LogisticRegression, german_credit_synthetic
from .stochvol import StochasticVolatility

__all__ = ["CorrelatedGaussian", "EightSchools", "HierarchicalRegression", "LinearRegression",
           "LogisticRegression", "NealsFunnel", "NonCenteredFunnel", "SpikedGaussian",
           "StandardNormal", "StochasticVolatility", "german_credit_synthetic"]
