#!/usr/bin/env python3
"""Time logistic regression's two paths of one checkout of littlemcmc_torch
on the card.

    python3 scripts/torch_path_ab.py [ROOT]

Runs, with the checkout at ROOT (default: the one this script is in),
BASELINE config 4's logistic regression (1000 x 25) at 1024 chains as
``chip_smoke.py``'s phases 3l-3m do: path (B), the default call on the
trajectory kernel's logistic body (500 + 1000 draws), and path (A), the
tensor-op tree with the batched logistic kernel at every leaf (200 + 200),
both from seed 42. Prints one JSON line: each path's ``sample_seconds``,
launches by kernel (the batched logistic kernel's too) and post-tune mean
tree size, and the card's name and power limit. To compare two
checkouts, run them in turns (A, B, B, A) in one command on one card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[1])
    sys.path.insert(0, str(root.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from littlemcmc_torch import NUTS, sample
    from littlemcmc_torch.models import LogisticRegression
    from littlemcmc_torch.ops import _build
    from littlemcmc_torch.ops.logistic import logistic_logp_grad

    _build.build_all()  # the kernels' build stays out of sample_seconds
    out = {"root": str(root)}
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
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
