"""Exceptions (parity with reference ``littlemcmc/exceptions.py:22-25``)."""

__all__ = ["SamplingError", "IntegrationError", "ParallelSamplingError"]


class SamplingError(RuntimeError):
    """Error while sampling."""


class IntegrationError(RuntimeError):
    """Numerical errors during leapfrog integration.

    Kept for API parity: the integrator never raises it. Non-finite values
    propagate and are caught by the divergence checks.
    """


class ParallelSamplingError(Exception):
    """Error in a parallel chain (reference ``parallel_sampling.py:32-38``).

    Kept for API parity: chains are batched in one device program, so
    per-chain failures surface as divergence flags and warnings.
    """

    def __init__(self, message, chain=None, warnings=None):
        super().__init__(message)
        self.message = message
        self.chain = chain
        self.warnings = warnings or []
