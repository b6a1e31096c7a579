"""Host-side utilities: convergence diagnostics."""

from .diagnostics import bfmi, ess_bulk, split_rhat, summary

__all__ = ["bfmi", "ess_bulk", "split_rhat", "summary"]
