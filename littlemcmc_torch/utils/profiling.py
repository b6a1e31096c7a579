"""Profiling hooks: device traces and throughput summaries.

Counterpart of ``littlemcmc_tpu/utils/profiling.py``: a sampling run can
be wrapped in a device profile (``torch.profiler`` with CPU and CUDA
activities), viewable in Perfetto or ``chrome://tracing``.

On the card :func:`device_trace` holds the trace to the port's launch
counters: every launch a kernel wrapper counts in the window must have
exactly one device record of that kernel in the trace, else it raises.
The profiler drops the first device records of a window, more of them
the more kernels the process launched outside its windows before (on an
H100 with PyTorch 2.11 and CUDA 12.8: none after 300,000 launches, one
from 600,000 to 2.4 million; all 20 of a window after the millions of a
whole ``chip_smoke.py``), whoever launched them. So
:func:`device_trace` opens its window with ``_PAD_LAUNCHES`` launches of
a one-element fill, whose records the profiler drops in place of the
block's, waits ``_SETTLE_S`` seconds, and waits again before it closes;
then it counts, and a loss it did not absorb raises instead of
undercounting.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import numpy as np

__all__ = ["device_trace", "throughput_report", "launch_counts", "device_records",
           "missing_records", "DeviceTrace"]

# seconds the profiler is left to settle after its window opens and
# before it closes, and the throwaway launches that open the window
_SETTLE_S = 0.05
_PAD_LAUNCHES = 2000


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch counter, by the name its kernels carry
    on the card (a substring of each kernel's symbol)."""
    from ..ops.autospec import probe_spec
    from ..ops.fused_hmc import fused_hmc
    from ..ops.fused_nuts import fused_nuts
    from ..ops.fused_probe import probe_kernel
    from ..ops.hmc_trajectory import hmc_trajectory
    from ..ops.logistic import logistic_logp_grad
    from ..ops.nuts_trajectory import trajectory
    from ..ops.quadform import quadform_logp_grad

    counts = {"nuts_trajectory": trajectory.launches, "fused_nuts": fused_nuts.launches,
              "hmc_trajectory": hmc_trajectory.launches, "fused_hmc": fused_hmc.launches,
              "logistic_logp_grad": logistic_logp_grad.launches,
              "quadform_logp_grad": quadform_logp_grad.launches,
              "autospec_probe": probe_spec.launches}
    counts.update({f"probe_{k}_kernel": n for k, n in probe_kernel.launches.items()})
    return counts


def device_records(prof) -> Dict[str, int]:
    """Device (CUDA) kernel records of a finished ``torch.profiler`` run,
    counted by kernel name."""
    import torch

    out: Dict[str, int] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0) + 1
    return out


def _records_of(records: Dict[str, int], name: str) -> int:
    """Device records of the kernels whose names hold ``name``."""
    return sum(n for k, n in records.items() if name in k)


def missing_records(launches: Dict[str, int], records: Dict[str, int]) -> Dict[str, tuple]:
    """The kernels whose device records (summed over the kernel names that
    hold the counter's name) differ from their launches: name ->
    ``(records, launches)``."""
    return {name: (_records_of(records, name), n) for name, n in launches.items()
            if _records_of(records, name) != n}


class DeviceTrace:
    """What :func:`device_trace` yields: ``profiler`` (the
    ``torch.profiler.profile``), ``block_start_ns`` (the host clock's ns
    when the block began, the profiler's clock too), and after the block
    ``path`` (the trace file), ``launches`` (each kernel wrapper's launches
    in the block) and ``records`` (device records by kernel name, the
    opening fills' among them)."""

    def __init__(self, profiler):
        self.profiler = profiler
        self.block_start_ns = 0
        self.path = None
        self.launches: Dict[str, int] = {}
        self.records: Dict[str, int] = {}

    def kernel_records(self, name: str) -> int:
        """Device records of the kernels whose names hold ``name``."""
        return _records_of(self.records, name)

    def busy_ms(self) -> float:
        """The device time of the kernel records that start after the
        window's opening fills (the block's)."""
        import torch

        return sum(e.end_ns() - e.start_ns()
                   for e in self.profiler.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA
                   and e.start_ns() >= self.block_start_ns) / 1e6


@contextlib.contextmanager
def device_trace(log_dir: str, check: bool = True):
    """Capture a device profile of everything inside the block and write it
    as a Chrome/Perfetto trace (``trace_<pid>_<ns>.json``) under
    ``log_dir``.

    With a CUDA device the profile holds CPU and CUDA activities, and with
    ``check`` each port kernel launched in the block must have one device
    record a launch: a shortfall raises ``RuntimeError`` rather than
    undercount in silence. Without one it holds the CPU activity only.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    before = launch_counts()
    with profile(activities=activities) as prof:
        tr = DeviceTrace(prof)
        if cuda:
            pad = torch.zeros(1, device="cuda")
            for _ in range(_PAD_LAUNCHES):
                pad.fill_(0.0)
            torch.cuda.synchronize()
            time.sleep(_SETTLE_S)
        tr.block_start_ns = time.time_ns()
        yield tr
        if cuda:
            torch.cuda.synchronize()
            time.sleep(_SETTLE_S)
    after = launch_counts()
    tr.launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    os.makedirs(log_dir, exist_ok=True)
    tr.path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(tr.path)
    if not cuda:
        return
    tr.records = device_records(prof)
    short = missing_records(tr.launches, tr.records)
    if check and short:
        raise RuntimeError(
            "torch.profiler did not keep one device record a launch (kernel: records, "
            f"launches): {short}; the trace is at {tr.path}")


def throughput_report(trace: np.ndarray, stats: Dict[str, np.ndarray], wall_seconds: float,
                      tune: int = 0) -> Dict[str, float]:
    """Transitions/s, leapfrogs/s and ESS/s for a finished run (the JAX
    package's keys and numbers)."""
    from .diagnostics import ess_bulk

    chains, draws, ndim = trace.shape
    transitions = chains * (draws + tune)
    leapfrogs = float(np.asarray(stats.get("tree_size", np.ones((1,)))).sum())
    ess = np.array([ess_bulk(trace[:, :, i]) for i in range(ndim)])
    return {
        "wall_seconds": wall_seconds,
        "transitions_per_sec": transitions / wall_seconds,
        "leapfrogs_per_sec_post_tune": leapfrogs / wall_seconds,
        "min_ess_bulk": float(np.nanmin(ess)),
        "ess_per_sec_min_dim": float(np.nanmin(ess) / wall_seconds),
    }
