#!/usr/bin/env python3
"""Smoke test of littlemcmc_torch on one CUDA card: build, check, run, time.

Run from the root of a checkout, on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, each printing its own lines:

1. the card (``nvidia-smi`` name and power limit), the CUDA version, and
   the build of every CUDA kernel from ``littlemcmc_torch/ops/csrc``;
2. the trajectory kernel against its plain PyTorch version on the card,
   one transition at the main path's shapes (1024 chains, the 100-d
   correlated Gaussian, tree depth 10) and at n = 4 (standard normal),
   from stationary inputs made with numpy from a fixed seed: the share of
   chains whose depth, leaf count, divergence and turning flags agree
   (100% for the standard normal, at least 99% for the correlated
   Gaussian), and the error of q, grad and energy on those chains (q
   within 1e-4 posterior sd, energy within 1e-3);
3. the main path: ``sample(CorrelatedGaussian(100).logp_grad,
   model_ndim=100, chains=1024, tune=500, draws=1000, random_seed=42)``,
   with the kernel's launch count set to 0 before and read after, and the
   posterior held to the model's known moments;
4. the kernel's time per launch at the main path's final state beside its
   plain version's time and its bound, where 50 more draws from that
   state spend their device time (``torch.profiler``), and one JSON line
   of kernels.

The last line is ``{"ok": true, "device": {...}}``. Any failure raises
and the script exits non-zero without that line. Without a CUDA device,
or run outside a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit)
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12

N, CHAINS, TUNE, DRAWS, DEPTH, CHAIN_BLOCK = 100, 1024, 500, 1000, 10, 8
FLAGS = ("depth", "n_leaves", "diverging", "turning")
Q_TOL_SD, E_TOL = 1e-4, 1e-3  # kernel vs plain, on the chains that agree


def _line(**kv) -> None:
    print(" ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def _cuda_time_ms(fn, reps: int, warmup: int) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
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


def _stationary_inputs(model, chol, C, eps, seed):
    """Trajectory inputs at stationarity, made with numpy: q ~ N(0, chol
    chol^T), an inverse-mass diagonal near the true variances, p ~ N(0, M)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n = model.ndim
    q = (rng.standard_normal((C, n)) @ chol.T).astype(np.float32)
    var = (model.true_var * rng.uniform(0.5, 2.0, (C, n))).astype(np.float32)
    p = (rng.standard_normal((C, n)) / np.sqrt(var)).astype(np.float32)
    eps = (eps * rng.uniform(0.8, 1.2, C)).astype(np.float32)
    dev = torch.device("cuda")
    qt = torch.from_numpy(q).to(dev)
    logp, grad = model.batched_logp_grad(qt)
    return (qt, torch.from_numpy(p).to(dev), grad.contiguous(), logp.contiguous(),
            torch.from_numpy(eps).to(dev),
            torch.full((C,), DEPTH, dtype=torch.int32, device=dev),
            torch.from_numpy(var).to(dev))


def _compare(name, model, args, seed, need):
    """One kernel launch against the plain version on the same inputs."""
    import numpy as np
    import torch
    from littlemcmc_torch.ops.nuts_trajectory import trajectory, trajectory_plain

    kw = dict(spec=model.trajectory_spec(), max_treedepth=DEPTH, Emax=1000.0,
              chain_block=CHAIN_BLOCK)
    got = trajectory(*args, seed, **kw)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want = trajectory_plain(*args, seed, **kw)
    end.record()
    end.synchronize()
    agree = torch.stack([got[k] == want[k] for k in FLAGS]).all(0)
    share = float(agree.float().mean())
    errs = {}
    for k in ("q", "grad", "energy"):
        d = (got[k] - want[k])[agree].abs()
        rel = d / want[k][agree].abs().clamp_min(1e-6)
        errs[f"{k}_max_abs"] = float(d.max())
        errs[f"{k}_max_rel"] = float(rel.max())
    sd = torch.from_numpy(np.sqrt(model.true_var)).float().to(got["q"].device)
    errs["q_max_err_in_sd"] = float(((got["q"] - want["q"]).abs() / sd)[agree].max())
    print(json.dumps({"phase": "kernel_vs_plain", "model": name, "chains": args[0].shape[0],
                      "ndim": args[0].shape[1], "agree_share": share,
                      "mean_depth": float(want["depth"].float().mean()),
                      "mean_leaves": float(want["n_leaves"].float().mean()),
                      "plain_ms": start.elapsed_time(end), **errs}), flush=True)
    if share < need:
        raise RuntimeError(f"{name}: kernel and plain version agree on {share:.4f} "
                           f"of chains, need {need}")
    # fp32 rounding of two summation orders, carried through up to 2^10
    # leapfrog steps: proposals within Q_TOL_SD posterior sds, energies
    # (about n in size) within E_TOL
    if errs["q_max_err_in_sd"] > Q_TOL_SD or errs["energy_max_abs"] > E_TOL:
        raise RuntimeError(f"{name}: kernel and plain version differ by "
                           f"{errs['q_max_err_in_sd']} sd in q (limit {Q_TOL_SD}) and "
                           f"{errs['energy_max_abs']} in energy (limit {E_TOL})")
    return errs["q_max_abs"]


def _bound_ms(n_leaves_total: int, C: int, n: int) -> tuple[float, str]:
    """Least time for one transition: per leaf and chain the 2n^2-FLOP
    matvec plus about 20n elementwise operations, plus the proposal's
    gradient; the inputs read once and the outputs written once."""
    ops = n_leaves_total * (2 * n * n + 20 * n) + C * (2 * n * n + 2 * n)
    nbytes = 4 * (4 * C * n + 3 * C + n * n) + 4 * (2 * C * n + 7 * C) + 2 * C
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _breakdown(model, state, gen, draws: int = 50) -> None:
    """Where a post-tune draw's time goes: ``draws`` transitions from the
    main path's final state under ``torch.profiler``; device time by
    kernel over the window's time on CUDA events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from littlemcmc_torch.base import NUTSConfig
    from littlemcmc_torch.nuts import build_nuts_kernel

    kernel = build_nuts_kernel(NUTSConfig(), model.trajectory_spec())
    kernel(state, False, gen, (1, 2))  # warm-up
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for i in range(draws):
            state, _ = kernel(state, False, gen, (100 + i, 7))
        end.record()
        end.synchronize()
    window_us = 1e3 * start.elapsed_time(end)
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            by_kernel[e.key] = e.self_device_time_total
    busy = sum(by_kernel.values())
    traj = sum(t for k, t in by_kernel.items() if "nuts_trajectory" in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:4]
    print(json.dumps({
        "phase": "breakdown", "draws": draws, "ms_per_draw": window_us / draws / 1e3,
        "device_busy_share": busy / window_us if busy else "not measured",
        "trajectory_kernel_share": traj / window_us if busy else "not measured",
        "trajectory_kernel_ms_per_draw": traj / draws / 1e3 if busy else "not measured",
        "other_kernels": len(by_kernel) - 1,
        "top_device_us": [[k[:60], t] for k, t in top]}), flush=True)


def main() -> int:
    if not (ROOT / "littlemcmc_torch" / "ops" / "csrc").is_dir():
        print("chip_smoke.py must run from a littlemcmc checkout "
              "(littlemcmc_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # matmuls feed comparisons
    t_start = time.perf_counter()

    # --- 1. the card and the build -------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    from littlemcmc_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    _line(phase="build", seconds=f"{time.perf_counter() - t0:.1f}",
          libraries=",".join(sorted(libs)), cuda=torch.version.cuda,
          torch=torch.__version__, device=torch.cuda.get_device_name(0).replace(" ", "_"))
    for name in sorted(libs):
        log = (libs[name].parent / f"{name}.log").read_text()
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"ptxas[{name}]: {ln.strip()}", flush=True)

    from littlemcmc_torch import sample
    from littlemcmc_torch.models import CorrelatedGaussian, StandardNormal
    from littlemcmc_torch.ops.nuts_trajectory import trajectory, trajectory_plain
    from littlemcmc_torch.utils.diagnostics import ess_bulk

    # --- 2. the kernel against its plain version -------------------------------
    cg = CorrelatedGaussian(N)
    args = _stationary_inputs(cg, np.linalg.cholesky(cg.cov), CHAINS, 0.2, seed=0)
    max_abs_err = _compare("correlated_gaussian", cg, args, (17, 29), need=0.99)
    sn = StandardNormal(4)
    _compare("standard_normal", sn, _stationary_inputs(sn, np.eye(4), CHAINS, 0.5, seed=1),
             (5, 6), need=1.0)

    # --- 3. the main path -------------------------------------------------------
    trajectory.launches = 0
    report = {}
    trace, stats, state = sample(cg.logp_grad, model_ndim=N, chains=CHAINS, tune=TUNE,
                                 draws=DRAWS, random_seed=42, perf_report=report,
                                 return_final_state=True, progressbar=False)
    launches = trajectory.launches
    if report["kernel_launches"] != TUNE + DRAWS or launches != TUNE + DRAWS:
        raise RuntimeError(f"main path launched the kernel {launches} times, "
                           f"expected {TUNE + DRAWS}")
    if trace.shape != (CHAINS, DRAWS, N) or not np.isfinite(trace).all():
        raise RuntimeError(f"bad trace: shape {trace.shape}, finite "
                           f"{np.isfinite(trace).all()}")
    t_ess = time.perf_counter()
    flat = trace.reshape(-1, N)
    sd = np.sqrt(cg.true_var)
    var_ratio = float((flat.var(0) / cg.true_var).mean())
    mean_err = float((np.abs(flat.mean(0)) / sd).max())
    div_rate = float(stats["diverging"].mean())
    min_ess = float(min(ess_bulk(trace[:, :, i]) for i in range(N)))
    secs = report["sample_seconds"]
    main = {"phase": "main_path", "engine": report["engine"],
            "trajectory": report["trajectory"], "chain_block": report["chain_block"],
            "chains": CHAINS, "ndim": N, "tune": TUNE, "draws": DRAWS,
            "kernel_launches": launches, "sample_seconds": secs,
            "transitions_per_s": CHAINS * (TUNE + DRAWS) / secs,
            "min_bulk_ess": min_ess, "min_bulk_ess_per_s": min_ess / secs,
            "divergence_rate": div_rate, "posterior_var_ratio": var_ratio,
            "max_abs_mean_over_sd": mean_err,
            "mean_tree_size": float(stats["tree_size"].mean()),
            "mean_depth": float(stats["depth"].mean()),
            "step_size": float(stats["step_size"][:, -1].mean()),
            "mean_tree_accept": float(stats["mean_tree_accept"].mean()),
            "ess_seconds": time.perf_counter() - t_ess, "card": smi}
    print(json.dumps(main), flush=True)
    gates = [("divergence_rate < 0.01", div_rate < 0.01),
             ("0.9 <= posterior_var_ratio <= 1.1", 0.9 <= var_ratio <= 1.1),
             ("max |mean| / sd < 0.1", mean_err < 0.1),
             ("min bulk ESS > 1000", min_ess > 1000)]
    failed = [g for g, ok in gates if not ok]
    if failed:
        raise RuntimeError(f"main path quality gates failed: {failed}")

    # --- 4. the kernel's time at the main path's final state -------------------
    gen = torch.Generator(device="cuda").manual_seed(7)
    pot = state.potential
    step_size = torch.exp(state.da.log_bar)
    targs = (state.q, pot.sample_momentum(gen), state.q_grad, state.logp, step_size,
             torch.full((CHAINS,), DEPTH, dtype=torch.int32, device="cuda"), pot.var)
    kw = dict(spec=cg.trajectory_spec(), max_treedepth=DEPTH, Emax=1000.0,
              chain_block=CHAIN_BLOCK)
    out = trajectory(*targs, (3, 8), **kw)
    leaves = int(out["n_leaves"].sum())
    kernel_ms = _cuda_time_ms(lambda: trajectory(*targs, (3, 8), **kw), reps=20, warmup=3)
    plain_ms = _cuda_time_ms(lambda: trajectory_plain(*targs, (3, 8), **kw), reps=1, warmup=0)
    bound_ms, bound_by = _bound_ms(leaves, CHAINS, N)
    _line(phase="timing", kernel_ms=f"{kernel_ms:.4f}", plain_ms=f"{plain_ms:.1f}",
          bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
          mean_leaves=f"{leaves / CHAINS:.2f}", elapsed_s=f"{time.perf_counter() - t_start:.1f}")
    _breakdown(cg, state, gen)
    print(json.dumps({"kernels": [{
        "name": "nuts_trajectory", "route": "cuda",
        "source": "littlemcmc_torch/ops/csrc/nuts_trajectory.cu",
        "replaces": "littlemcmc_tpu/ops/nuts_trajectory_pallas.py:1023",
        "launches": launches, "max_abs_err": max_abs_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        # no single PyTorch call computes a NUTS transition
        "library_ms": None}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
