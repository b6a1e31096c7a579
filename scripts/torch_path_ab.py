#!/usr/bin/env python3
"""Time whole ``sample()`` paths of one checkout of littlemcmc_torch on the
card.

    python3 scripts/torch_path_ab.py [ROOT] [--paths=logistic,adapt_full,lowrank,eight_schools,hmc,main]

Runs, with the checkout at ROOT (default: the one this script is in),
from seed 42 at 1024 chains (default: every group):

- ``logistic``: BASELINE config 4's logistic regression (1000 x 25) as
  ``chip_smoke.py``'s phases 3l-3m do: path (B), the default call on the
  trajectory kernel's logistic body (500 + 1000 draws), and path (A), the
  tensor-op tree with the batched logistic kernel at every leaf (200 +
  200);
- ``adapt_full``: the 100-d correlated Gaussian with ``init="adapt_full"``
  (500 + 1000) as phases 3b-3c do: the fused engine and its per-draw twin,
  and each fused launch's device ms from a profiled repeat of the fused
  call;
- ``lowrank``: the 100-d spiked Gaussian with ``init="jitter+adapt_lowrank"``
  (500 + 1000) as phases 3o-3q do: L1 on the fused engine, L2, its
  per-draw twin, and L3, L1 with ``HamiltonianMC`` (the fused HMC
  kernel's low-rank instance), each with its min bulk ESS, min-bulk-ESS/s
  and its dimensions' variance ratios, and each of L1's and L3's fused
  launches' device ms from a profiled repeat;
- ``eight_schools``: eight schools at 10,240 chains (500 + 500,
  ``target_accept=0.95``) as phases 3g-3j do: with NUTS the ``fused_diag``
  cell and its ``fuse_draws=False`` twin, with ``HamiltonianMC`` the
  ``fused_diag`` cell (the fused HMC kernel's diag instance), each with its
  min bulk ESS over the 10 dimensions, min-bulk-ESS/s, max split R-hat and
  mu's and log_tau's posterior means against the exact ones, and each of
  the fused cells' four launches' device ms from a profiled repeat;
- ``hmc``: the 100-d correlated Gaussian with ``HamiltonianMC`` (500 +
  1000) as phases 3d-3e do: HMC's main path (``per_draw_diag`` on the
  HMC trajectory kernel) and HMC ``adapt_full`` (``fused_dense_pooled``
  on the fused HMC kernel), each with its min bulk ESS over the 100
  dimensions and min-bulk-ESS/s, and each of ``adapt_full``'s fused
  launches' device ms from a profiled repeat;
- ``main``: the NUTS main path's default call (the 100-d correlated
  Gaussian, ``per_draw_diag``) three times, each call's
  ``sample_seconds`` and the traces' digests.

Prints one JSON line: each path's ``sample_seconds``, launches by kernel
(the batched logistic kernel's too), mean tree size, the fused launches'
ms where timed, and the card's name and power limit. To compare two
checkouts, run them in turns (A, B, B, A) in one command on one card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


def _logistic_paths(out: dict) -> None:
    from littlemcmc_torch import NUTS, sample
    from littlemcmc_torch.models import LogisticRegression
    from littlemcmc_torch.ops.logistic import logistic_logp_grad

    for path, model, tune, draws in (("B", LogisticRegression(), 500, 1000),
                                     ("A", LogisticRegression(use_kernel=True), 200, 200)):
        kw = {} if path == "B" else {"step": NUTS(
            model_ndim=model.ndim, batched_logp_dlogp_func=model.batched_logp_grad,
            trajectory_spec=None)}
        report, launches = {}, logistic_logp_grad.launches
        _, stats = sample(model.logp_grad, model_ndim=model.ndim, chains=1024, tune=tune,
                          draws=draws, random_seed=42, perf_report=report, progressbar=False,
                          compute_convergence_checks=False, **kw)
        tree = stats.get("tree_size", stats.get("n_steps"))
        out[path] = {"engine": report["engine"], "trajectory": report.get("trajectory"),
                     "sample_seconds": report["sample_seconds"],
                     "kernel_launches": report.get("kernel_launches"),
                     "logistic_logp_grad_launches": logistic_logp_grad.launches - launches,
                     "mean_tree_size": float(tree.mean()) if tree is not None else None}


def _adapt_full_paths(out: dict) -> None:
    """The two ``adapt_full`` cells on the 100-d correlated Gaussian (1024
    chains, 500 + 1000, seed 42), as ``chip_smoke.py``'s phases 3b-3c run
    them: the fused engine and its per-draw twin (``fuse_draws=False``),
    each once as the user calls it, then the fused call once more under
    ``torch.profiler`` for each fused launch's device ms
    (``chip_smoke._fused_path_breakdown``)."""
    import chip_smoke
    from littlemcmc_torch import sample
    from littlemcmc_torch.models import CorrelatedGaussian

    model = CorrelatedGaussian(100)
    for path, fuse in (("adapt_full_fused", None), ("adapt_full_per_draw", False)):
        report = {}
        _, stats = sample(model.logp_grad, model_ndim=100, chains=1024, tune=500, draws=1000,
                          random_seed=42, init="adapt_full", fuse_draws=fuse,
                          perf_report=report, progressbar=False,
                          compute_convergence_checks=False)
        out[path] = {"engine": report["engine"], "sample_seconds": report["sample_seconds"],
                     "kernel_launches": report.get("kernel_launches"),
                     "mean_tree_size": float(stats["tree_size"].mean()),
                     "mean_depth": float(stats["depth"].mean())}
    line = chip_smoke._fused_path_breakdown(model)
    out["adapt_full_fused"].update({k: line.get(k) for k in _BREAKDOWN_KEYS})


_BREAKDOWN_KEYS = ("fused_launch_ms", "fused_tune_ms", "fused_draw_ms", "device_busy_share",
                   "sample_seconds_profiled")


def _lowrank_paths(out: dict) -> None:
    """The low-rank cells L1, L2 and L3 on ``SpikedGaussian(100)`` (1024
    chains, 500 + 1000, seed 42, ``init="jitter+adapt_lowrank"``, pooled),
    as ``chip_smoke.py``'s phases 3o-3q run them: the fused engine, its
    per-draw twin (``fuse_draws=False``) and the fused engine with
    ``HamiltonianMC``, each once as the user calls it, with the min bulk
    ESS over the 100 dimensions, min-bulk-ESS/s and the smallest and
    largest of the dimensions' variance ratios (the cells' gate: each in
    [0.9, 1.1]); then L1 and L3 once more under ``torch.profiler`` for
    each fused launch's device ms (``chip_smoke._fused_path_breakdown``)."""
    from concurrent.futures import ThreadPoolExecutor

    import chip_smoke
    from littlemcmc_torch import HamiltonianMC, sample
    from littlemcmc_torch.models import SpikedGaussian
    from littlemcmc_torch.utils.diagnostics import ess_bulk

    model = SpikedGaussian(100)
    kw = dict(model_ndim=100, chains=1024, tune=500, draws=1000, init="jitter+adapt_lowrank")
    hmc = dict(kw, step=HamiltonianMC(model_ndim=100))
    for path, fuse, pkw in (("L1", None, kw), ("L2", False, kw), ("L3", None, hmc)):
        report = {}
        trace, stats = sample(model.logp_grad, random_seed=42, fuse_draws=fuse,
                              perf_report=report, progressbar=False,
                              compute_convergence_checks=False, **pkw)
        with ThreadPoolExecutor(8) as pool:
            ess = float(min(pool.map(lambda i: ess_bulk(trace[:, :, i]), range(100))))
        ratio = trace.reshape(-1, 100).var(0) / model.true_var
        work = stats["tree_size"] if "tree_size" in stats else stats["n_steps"]
        out[path] = {"engine": report["engine"], "sample_seconds": report["sample_seconds"],
                     "kernel_launches": report.get("kernel_launches"),
                     "mean_tree_size" if "tree_size" in stats else "mean_n_steps":
                         float(work.mean()),
                     "divergence_share": float(stats["diverging"].mean()),
                     "var_ratio_min": float(ratio.min()), "var_ratio_max": float(ratio.max()),
                     "min_bulk_ess": ess, "min_bulk_ess_per_s": ess / report["sample_seconds"]}
    for path, step, pkw in (("L1", "nuts", kw), ("L3", "hmc", hmc)):
        line = chip_smoke._fused_path_breakdown(model, step, pkw, draw_chunks=4,
                                                label="_lowrank")
        out[path].update({k: line.get(k) for k in _BREAKDOWN_KEYS})


def _eight_schools_paths(out: dict) -> None:
    """Eight schools' cells (``EightSchools()``, 10,240 chains, 500 + 500,
    ``target_accept=0.95``, seed 42) as ``chip_smoke.py``'s phases 3g-3j run
    them: with NUTS the ``fused_diag`` engine and its per-draw twin
    (``fuse_draws=False``), with ``HamiltonianMC`` the ``fused_diag``
    engine, each once as the user calls it, with the min bulk ESS over the
    10 dimensions, min-bulk-ESS/s, the max split R-hat and mu's and
    log_tau's posterior means in exact posterior sds from the exact ones
    (the gates: R-hat < 1.05, each mean within 0.1 sd); then each fused
    call once more under ``torch.profiler`` for each fused launch's device
    ms (``chip_smoke._fused_path_breakdown``)."""
    import numpy as np

    import chip_smoke
    from littlemcmc_torch import NUTS, HamiltonianMC, sample
    from littlemcmc_torch.models import EightSchools
    from littlemcmc_torch.utils.diagnostics import ess_bulk, split_rhat

    model = EightSchools()
    exact = model.exact_moments()
    kw = dict(model_ndim=10, chains=chip_smoke.ES_CHAINS, tune=chip_smoke.ES_TUNE,
              draws=chip_smoke.ES_DRAWS)
    steps = {"nuts": lambda: NUTS(model_ndim=10, target_accept=chip_smoke.ES_TARGET),
             "hmc": lambda: HamiltonianMC(model_ndim=10, target_accept=chip_smoke.ES_TARGET)}
    for path, fuse, step in (("eight_schools_fused", None, "nuts"),
                             ("eight_schools_per_draw", False, "nuts"),
                             ("eight_schools_hmc_fused", None, "hmc")):
        report = {}
        trace, stats = sample(model.logp_grad, random_seed=42, fuse_draws=fuse,
                              step=steps[step](), perf_report=report, progressbar=False,
                              compute_convergence_checks=False, **kw)
        ess = float(min(ess_bulk(trace[:, :, i]) for i in range(10)))
        work = stats["tree_size"] if "tree_size" in stats else stats["n_steps"]
        out[path] = {"engine": report["engine"], "sample_seconds": report["sample_seconds"],
                     "kernel_launches": report.get("kernel_launches"),
                     "mean_tree_size" if "tree_size" in stats else "mean_n_steps":
                         float(work.mean()),
                     "divergence_share": float(stats["diverging"].mean()),
                     "max_split_rhat": float(max(split_rhat(trace[:, :, i])
                                                 for i in range(10))),
                     "min_bulk_ess": ess, "min_bulk_ess_per_s": ess / report["sample_seconds"]}
        for i, name in enumerate(("mu", "log_tau")):
            mean, sd = exact[name]
            out[path][f"{name}_mean_err_in_sd"] = float(
                abs(trace[:, :, i].astype(np.float64).mean() - mean) / sd)
    for path, step in (("eight_schools_fused", "nuts"), ("eight_schools_hmc_fused", "hmc")):
        line = chip_smoke._fused_path_breakdown(model, step, dict(kw, step=steps[step]()),
                                                draw_chunks=2, label="_eight_schools")
        out[path].update({k: line.get(k) for k in _BREAKDOWN_KEYS})


def _hmc_paths(out: dict) -> None:
    """HMC on the 100-d correlated Gaussian (1024 chains, 500 + 1000, seed
    42) as ``chip_smoke.py``'s phases 3d-3e run it: the main path
    (``jitter+adapt_diag`` on the per-draw HMC kernel) and ``adapt_full``
    (the pooled dense metric on the fused HMC kernel), each once as the
    user calls it, with the min bulk ESS over the 100 dimensions and
    min-bulk-ESS/s; then the ``adapt_full`` call once more under
    ``torch.profiler`` for each fused launch's device ms
    (``chip_smoke._fused_path_breakdown``)."""
    from concurrent.futures import ThreadPoolExecutor

    import chip_smoke
    from littlemcmc_torch import HamiltonianMC, sample
    from littlemcmc_torch.models import CorrelatedGaussian
    from littlemcmc_torch.utils.diagnostics import ess_bulk

    model = CorrelatedGaussian(100)
    for path, init in (("hmc_main", None), ("hmc_adapt_full", "adapt_full")):
        report = {}
        kw = {"init": init} if init else {}
        trace, stats = sample(model.logp_grad, model_ndim=100, chains=1024, tune=500,
                              draws=1000, random_seed=42, step=HamiltonianMC(model_ndim=100),
                              perf_report=report, progressbar=False,
                              compute_convergence_checks=False, **kw)
        with ThreadPoolExecutor(8) as pool:
            ess = float(min(pool.map(lambda i: ess_bulk(trace[:, :, i]), range(100))))
        out[path] = {"engine": report["engine"], "sample_seconds": report["sample_seconds"],
                     "kernel_launches": report.get("kernel_launches"),
                     "mean_n_steps": float(stats["n_steps"].mean()),
                     "accept": float(stats["accept"].mean()),
                     "divergence_share": float(stats["diverging"].mean()),
                     "step_size": float(stats["step_size"][:, -1].mean()),
                     "min_bulk_ess": ess, "min_bulk_ess_per_s": ess / report["sample_seconds"]}
    line = chip_smoke._fused_path_breakdown(model, step="hmc")
    out["hmc_adapt_full"].update({k: line.get(k) for k in _BREAKDOWN_KEYS})


def _main_paths(out: dict) -> None:
    """The NUTS main path as a user calls it, with no argument past the
    defaults: the 100-d correlated Gaussian (1024 chains, 500 + 1000, seed
    42, ``per_draw_diag`` on the trajectory kernel), three times in a row,
    with each call's ``sample_seconds`` and the trace's digest (equal
    digests: the same bits)."""
    import hashlib

    from littlemcmc_torch import sample
    from littlemcmc_torch.models import CorrelatedGaussian

    model = CorrelatedGaussian(100)
    secs, digests = [], set()
    for _ in range(3):
        report = {}
        trace, stats = sample(model.logp_grad, model_ndim=100, chains=1024, tune=500,
                              draws=1000, random_seed=42, perf_report=report,
                              progressbar=False, compute_convergence_checks=False)
        secs.append(report["sample_seconds"])
        digests.add(hashlib.sha256(trace.tobytes()).hexdigest()[:16])
    out["main"] = {"engine": report["engine"], "sample_seconds": secs,
                   "kernel_launches": report.get("kernel_launches"),
                   "transfer_seconds": report.get("transfer_seconds"),
                   "mean_tree_size": float(stats["tree_size"].mean()),
                   "digests": sorted(digests)}


PATHS = {"logistic": _logistic_paths, "adapt_full": _adapt_full_paths,
         "lowrank": _lowrank_paths, "eight_schools": _eight_schools_paths, "hmc": _hmc_paths,
         "main": _main_paths}


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--paths=")]
    chosen = [a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--paths=")]
    paths = chosen[0].split(",") if chosen else list(PATHS)
    root = Path(args[0] if args else Path(__file__).resolve().parents[1])
    sys.path.insert(0, str(root.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from littlemcmc_torch.ops import _build

    _build.build_all()  # the kernels' build stays out of sample_seconds
    out = {"root": str(root)}
    for name in paths:
        PATHS[name](out)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
