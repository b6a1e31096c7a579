"""Profiling hooks (``littlemcmc_torch.utils.profiling``) against the JAX
package's (``littlemcmc_tpu/utils/profiling.py``) on the CPU.

- ``throughput_report`` gives the JAX function's keys and numbers on the
  same numpy inputs (rtol 1e-6), through the port's own ``ess_bulk``.
- ``device_trace`` writes a Chrome trace of the block; off the card it
  holds the CPU activity and checks nothing.
- The record check: each launch counter's name is held by the CUDA
  kernels it counts (the ``__global__`` symbols of ``ops/csrc``), and a
  shortfall of device records is reported by kernel.
The card's side (one device record a launch around a ``sample()``) is
``chip_smoke.py``'s ``device_trace`` phase.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest

from littlemcmc_tpu.utils.profiling import throughput_report as jax_throughput_report
from littlemcmc_torch.utils.profiling import (device_trace, launch_counts, missing_records,
                                              throughput_report)

CSRC = Path(__file__).resolve().parents[1] / "littlemcmc_torch" / "ops" / "csrc"


def _run(seed, chains=4, draws=200, ndim=3, with_tree=True):
    rng = np.random.default_rng(seed)
    # AR(1) draws, so the ESS is well below the draw count
    x = np.zeros((chains, draws, ndim))
    for t in range(1, draws):
        x[:, t] = 0.6 * x[:, t - 1] + rng.standard_normal((chains, ndim))
    stats = {"depth": rng.integers(1, 5, (chains, draws))}
    if with_tree:
        stats["tree_size"] = rng.integers(1, 16, (chains, draws)).astype(np.float64)
    return x.astype(np.float32), stats


@pytest.mark.parametrize("tune", [0, 150])
@pytest.mark.parametrize("with_tree", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_throughput_report_matches_jax(tune, with_tree, seed):
    trace, stats = _run(seed, with_tree=with_tree)
    got = throughput_report(trace, stats, 2.5, tune=tune)
    want = jax_throughput_report(trace, stats, 2.5, tune=tune)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_device_trace_writes_a_trace_off_the_card(tmp_path):
    import torch

    with device_trace(str(tmp_path / "tr")) as tr:
        x = torch.ones(64)
        for _ in range(3):
            x = x * 2.0
    assert tr.path is not None and Path(tr.path).parent == tmp_path / "tr"
    events = json.loads(Path(tr.path).read_text())["traceEvents"]
    assert any("aten::mul" in str(e.get("name")) for e in events)
    assert tr.launches == {} and tr.records == {}


def test_every_launch_counter_names_its_kernels():
    """``launch_counts`` covers every kernel wrapper, and each counter's name
    is a substring of the CUDA kernels it counts."""
    symbols = set()
    for path in CSRC.glob("*.cu"):
        src = path.read_text()
        for head in re.findall(r"__global__([^{;]*)", src):
            symbols |= set(re.findall(r"\b(\w+_kernel)\s*\(", head))
    counts = launch_counts()
    assert set(counts) >= {"nuts_trajectory", "fused_nuts", "hmc_trajectory", "fused_hmc",
                           "logistic_logp_grad", "quadform_logp_grad", "autospec_probe",
                           "probe_cos_kernel", "probe_thin_factor_kernel"}
    for name in counts:
        assert any(name in s for s in symbols), (name, sorted(symbols))
    # no counter's name is held by another wrapper's kernels
    for name in counts:
        owners = {other for other in counts for s in symbols if name in s and other in s}
        assert owners == {name}, (name, owners)


def test_missing_records_reports_each_short_kernel():
    records = {"void nuts_trajectory_kernel<1, 0, false>(Args)": 18,
               "void nuts_trajectory_dense_block_kernel<1>(Args)": 30,
               "probe_cos_kernel(float const*, float*, int)": 1,
               "elementwise_kernel": 500}
    assert missing_records({"nuts_trajectory": 48, "probe_cos_kernel": 1}, records) == {}
    assert missing_records({"nuts_trajectory": 50, "fused_nuts": 2}, records) == {
        "nuts_trajectory": (48, 50), "fused_nuts": (0, 2)}
