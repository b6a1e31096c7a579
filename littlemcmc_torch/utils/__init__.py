"""Host-side utilities: convergence diagnostics, profiling
(:mod:`.profiling`) and checkpoints (:mod:`.checkpoint`)."""

from .checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from .diagnostics import bfmi, ess_bulk, split_rhat, summary, to_arviz
from .profiling import device_trace, throughput_report

__all__ = ["bfmi", "ess_bulk", "split_rhat", "summary", "to_arviz", "device_trace",
           "throughput_report", "save_checkpoint", "restore_checkpoint", "latest_checkpoint"]
