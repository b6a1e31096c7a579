#!/usr/bin/env python3
"""Time the kernels of one checkout of littlemcmc_torch on the card.

    python3 scripts/torch_kernel_ab.py [ROOT]

Builds the CUDA kernels of the checkout at ROOT (default: the one this
script is in) and prints one JSON line: ptxas's register, stack-frame and
spill lines of every kernel, and the milliseconds per launch of the NUTS
trajectory kernel, the fused NUTS kernel and the fused HMC kernel at the
shapes of ``chip_smoke.py``'s phases 2, 2c and 2e (1024 chains, the 100-d
correlated Gaussian): one diag-metric transition from stationary inputs,
and a 4-draw dense draw chunk of each fused kernel; the HMC trajectory
kernel at phase 2d's input (the same positions, step counts from a fixed
seed; device time under ``torch.profiler``). Where the checkout has
them, also the batched model kernels at phase 2j's widths (1024 chains;
the logistic regression's 1000 x 25 design, the 100-d precision): CUDA
events around back-to-back calls (which hold the wrapper's host work too)
and the kernel's device time under ``torch.profiler``. The inputs are made
with numpy from fixed seeds, so two checkouts see the same work. To
compare two checkouts, run them in turns (A, B, B, A) in one command on
one card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


def _ms(fn, reps: int, warmup: int) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, name: str, reps: int):
    """Mean device ms of the kernel whose name holds ``name`` over ``reps``
    calls under ``torch.profiler``, or None where it kept no record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key)
    return us / reps / 1e3 if us else None


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[1])
    sys.path.insert(0, str(root.resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from littlemcmc_torch.base import NUTSConfig
    from littlemcmc_torch.models import CorrelatedGaussian
    from littlemcmc_torch.ops import _build
    from littlemcmc_torch.base import HMCConfig
    from littlemcmc_torch.ops.fused_hmc import fused_hmc
    from littlemcmc_torch.ops.fused_nuts import fused_nuts
    from littlemcmc_torch.ops.nuts_trajectory import trajectory

    libs = _build.build_all()
    ptxas = {name: [ln.strip() for ln in (libs[name].parent / f"{name}.log").read_text()
                    .splitlines() if "registers" in ln or "spill" in ln or "entry" in ln]
             for name in sorted(libs)}

    C, n, dev = 1024, 100, torch.device("cuda")
    model = CorrelatedGaussian(n)
    chol = np.linalg.cholesky(model.cov)
    rng = np.random.default_rng(0)

    def t(x, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)

    # phase 2's input: q ~ N(0, cov), inverse mass near the true variances
    q = t(rng.standard_normal((C, n)) @ chol.T)
    var = model.true_var * rng.uniform(0.5, 2.0, (C, n))
    p = t(rng.standard_normal((C, n)) / np.sqrt(var))
    logp, grad = model.batched_logp_grad(q)
    eps = t(0.2 * rng.uniform(0.8, 1.2, C))
    targs = (q, p, grad.contiguous(), logp.contiguous(), eps,
             torch.full((C,), 10, dtype=torch.int32, device=dev), t(var))
    tkw = dict(spec=model.trajectory_spec(), max_treedepth=10, Emax=1000.0, chain_block=8)
    traj_ms = _ms(lambda: trajectory(*targs, (17, 29), **tkw), reps=20, warmup=3)

    # phase 2c's input: the true covariance as the metric, step near 0.5
    ls = t(-0.7 + rng.uniform(-0.1, 0.1, C))
    cov = t(model.cov)
    linv = torch.linalg.solve_triangular(torch.linalg.cholesky(cov), torch.eye(n, device=dev),
                                         upper=False)
    f = dict(dtype=torch.float32, device=dev)
    fargs = (q, grad.contiguous(), logp.contiguous(), torch.full((C,), 300.0, **f), ls,
             ls.clone(), torch.zeros(C, **f), torch.full((C,), 40.0, **f), ls + np.log(10.0),
             cov, linv)
    fkw = dict(spec=model.trajectory_spec(), T=4, tuning=False, config=NUTSConfig(),
               chain_block=8)
    fused_ms = _ms(lambda: fused_nuts(*fargs, (41, -7), **fkw), reps=10, warmup=2)
    hkw = dict(fkw, config=HMCConfig())
    fused_hmc_ms = _ms(lambda: fused_hmc(*fargs, (53, -11), **hkw), reps=10, warmup=2)

    from littlemcmc_torch.ops.hmc_trajectory import hmc_trajectory

    n_steps = torch.clamp((t(rng.uniform(size=C)) * 2.0 / eps).to(torch.int32), 1, 1024)
    hargs = targs[:5] + (n_steps, targs[6])
    hkw = dict(spec=model.trajectory_spec(), Emax=1000.0)
    model_ms = {"hmc_trajectory_device_ms": _device_ms(
        lambda: hmc_trajectory(*hargs, (61, -67), **hkw), "hmc_trajectory", 50)}
    try:
        from littlemcmc_torch.models import LogisticRegression
        from littlemcmc_torch.ops.logistic import logistic_logp_grad
        from littlemcmc_torch.ops.quadform import quadform_logp_grad
    except ImportError:  # a checkout from before the batched model kernels
        pass
    else:
        lg = LogisticRegression()
        ql = t(0.3 * rng.standard_normal((C, lg.ndim)))
        packed = lg.trajectory_spec().kernel_consts
        for name, fn in (("logistic_logp_grad", lambda: logistic_logp_grad(
                              ql, lg.Xb, lg.y, lg.prior_prec, packed=packed)),
                         ("quadform_logp_grad", lambda: quadform_logp_grad(q, model.prec_f32))):
            model_ms[f"{name}_ms"] = _ms(fn, reps=200, warmup=10)
            model_ms[f"{name}_device_ms"] = _device_ms(fn, f"{name}_kernel", 200)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"root": str(root), "card": smi, "ptxas": ptxas,
                      "nuts_trajectory_diag_ms": traj_ms, "fused_nuts_4_draws_ms": fused_ms,
                      "fused_hmc_4_draws_ms": fused_hmc_ms, **model_ms}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
