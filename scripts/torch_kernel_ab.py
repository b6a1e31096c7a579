#!/usr/bin/env python3
"""Time the kernels of one checkout of littlemcmc_torch on the card.

    python3 scripts/torch_kernel_ab.py [ROOT] [--cases=CASE,...]

Builds the CUDA kernels of the checkout at ROOT (default: the one this
script is in) and prints one JSON line: ptxas's register, stack-frame and
spill lines of every kernel (and of the NUTS trajectory kernel built with
``HierarchicalRegression``'s generated body), and the milliseconds per
launch of the NUTS
trajectory kernel, the fused NUTS kernel and the fused HMC kernel at the
shapes of ``chip_smoke.py``'s phases 2, 2c and 2e (1024 chains, the 100-d
correlated Gaussian): one diag-metric transition from stationary inputs,
and a 4-draw dense draw chunk of each fused kernel; the HMC trajectory
kernel at phase 2d's input (the same positions, step counts from a fixed
seed; device time under ``torch.profiler``). Where the checkout has
them, also the batched model kernels at phase 2j's widths (1024 chains;
the logistic regression's 1000 x 25 design, the 100-d precision): CUDA
events around back-to-back calls (which hold the wrapper's host work too),
the kernel's device time under ``torch.profiler``, and the host time of
a tree leaf's pattern (the call, a reduction, a host read). Then the
trajectory kernel's model bodies that the port's paths spend most in:
the logistic body (3) at ``chip_smoke.py``'s phase 2k input and at path
(B)'s final state, and the generated ``HierarchicalRegression`` body at
H1's final state (1024 chains each, tree depth 10; CUDA events and the
device time under ``torch.profiler``). Then the NUTS transition's diag
and dense instances of ``scripts/torch_transition_clocks.py``: rows 1
diag and 2b body 1 (the per-draw launch and a 250-draw fused launch, 1024
chains) at phase 2's input and at the main path's final state, row 2a (the
funnel's fused launch) at F1's final state and 2p's input, the funnel per
draw at 2o's, row 1 body 4 (the spiked Gaussian per draw) at L0's final
state and 2m's input, the spiked Gaussian's fused instance in a 2-draw
chunk, row 2 dense (a 250-draw launch at ``adapt_full``'s final state,
phase 2c's 4-draw tune chunk), row 1 dense (phase 2b's input, the
per-draw twin's final state), row 2c (a 250-draw launch at L1's final
state), row 1 low-rank (L2's final state, phase 2m's low-rank input),
rows 2b body 2 and 1 body 2 (eight schools at 10,240 chains: a 250-draw
launch at the NUTS ``fused_diag`` cell's final state, a per-draw launch
at its twin's, and one at phase 2f's 1024-chain input), and rows 3 and 4
dense (HMC: the per-draw launch at the HMC main path's final state and at
phase 2d's input, the fused dense instance's 250-draw launch at HMC
``adapt_full``'s final state and phase 2e's 4-draw tune chunk), and rows
4c and 4b (the fused HMC kernel's low-rank and eight-schools instances: a
250-draw launch at L3's and at the eight-schools HMC cell's final states,
and each cell's 4-draw tune chunk): ms a
launch (CUDA events), a digest of the outputs (equal digests: the two checkouts give
the same bits), the blocks an SM and waves of the launch (where the
checkout records them), and from a build with the section clocks the
grid's tail share and the sections' shares (for HMC also the wait share
and the steps a chain and a block runs; the final states,
kept in ``build/`` by that script, the first run samples with its
checkout and the later ones load). The inputs are made with numpy
from fixed seeds, so two checkouts see the same work; the final states
come from ``build/kernel_ab_states.pt`` beside this script, which the
first run samples (``sample()`` of the checkout it runs, seed 42: path
(B) 500 + 1000, H1 500 + 3000 at target_accept 0.9) and the later ones
load (delete it to sample anew). ``--cases`` runs only those transition
cases (``torch_transition_clocks.py``'s names; the rest of the line is
timed as always). To compare two checkouts, run them in turns (A, B, B, A)
in one command on one card.
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


def _leaf_ms(fn, reps: int, warmup: int) -> float:
    """Host milliseconds an iteration of a tree leaf's pattern takes: the
    call, a PyTorch reduction of its outputs and a host read of it (so
    the kernel's device time sits on the host's path)."""
    import time

    for _ in range(warmup):
        float(sum(x.sum() for x in fn()))
    t0 = time.perf_counter()
    for _ in range(reps):
        logp, grad = fn()
        float(logp.sum() + grad.sum())
    return (time.perf_counter() - t0) * 1e3 / reps


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


def _final_states(path: Path) -> dict:
    """Path (B)'s and H1's final states as trajectory inputs ``(q, p, grad,
    logp, step, depth cap, inverse mass)``: loaded from ``path``, or
    sampled with this checkout and saved there."""
    import torch

    if path.exists():
        return torch.load(path)
    from littlemcmc_torch import NUTS, sample
    from littlemcmc_torch.models import HierarchicalRegression, LogisticRegression

    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    hr = HierarchicalRegression()
    for key, model, kw in (("logistic", LogisticRegression(), dict(tune=500, draws=1000)),
                           ("hierarchical", hr, dict(tune=500, draws=3000, step=NUTS(
                               model_ndim=hr.ndim, target_accept=0.9)))):
        _, _, s = sample(model.logp_grad, model_ndim=model.ndim, chains=1024, random_seed=42,
                         return_final_state=True, progressbar=False,
                         compute_convergence_checks=False, **kw)
        out[key] = tuple(x.contiguous() for x in (
            s.q, s.potential.sample_momentum(gen), s.q_grad, s.logp, torch.exp(s.da.log_bar),
            torch.full((1024,), 10, dtype=torch.int32, device="cuda"), s.potential.var))
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(out, path)
    return out


def _body_times(states_path: Path) -> dict:
    """The trajectory kernel with the logistic body at phase 2k's input and
    at path (B)'s final state, and with the generated hierarchical body at
    H1's final state: events and device ms a launch, leaves a chain, and
    the generated build's ptxas lines."""
    import chip_smoke
    from littlemcmc_torch.models import HierarchicalRegression, LogisticRegression
    from littlemcmc_torch.ops import _build
    from littlemcmc_torch.ops.autospec import header_source
    from littlemcmc_torch.ops.nuts_trajectory import trajectory

    states = _final_states(states_path)
    lg, hr = LogisticRegression(), HierarchicalRegression()
    cases = (("logistic_2k", lg, chip_smoke._posterior_inputs(lg, 1024, 0.25, 17), (109, -113)),
             ("logistic_b_final", lg, states["logistic"], (3, 8)),
             ("hierarchical_h1_final", hr, states["hierarchical"], (3, 8)))
    out = {}
    for name, model, args, seed in cases:
        kw = dict(spec=model.trajectory_spec(), max_treedepth=10, Emax=1000.0, chain_block=8)
        leaves = trajectory(*args, seed, **kw)["n_leaves"].float().mean()
        out[f"{name}_leaves_per_chain"] = float(leaves)
        out[f"{name}_ms"] = _ms(lambda: trajectory(*args, seed, **kw), reps=20, warmup=3)
        out[f"{name}_device_ms"] = _device_ms(lambda: trajectory(*args, seed, **kw),
                                              "nuts_trajectory_kernel", 20)
    log = _build._generated_job("nuts_trajectory", header_source(hr.trajectory_spec().auto))[2]
    out["ptxas_hierarchical_generated"] = [
        ln.strip() for ln in log.read_text().splitlines()
        if "registers" in ln or "spill" in ln or "entry" in ln]
    return out


def _transition_rows(root: Path, only=None) -> dict:
    """The NUTS transition's diag and dense instances at the inputs of
    :func:`torch_transition_clocks.run_clocks`: rows 1 diag and 2b body 1
    at phase 2's input and the main path's final state, row 2a (the
    funnel's fused instance) at F1's final state and phase 2p's input, the
    funnel per draw at phase 2o's input, row 1 body 4 (the spiked Gaussian
    per draw) at L0's final state and phase 2m's input, its fused
    instance in a 2-draw chunk at 2m's positions, row 2 dense at
    ``adapt_full``'s final state and phase 2c's tune chunk, row 1 dense at
    phase 2b's input and the per-draw twin's final state, row 2c at L1's
    final state, row 1 low-rank at L2's final state and phase 2m's
    low-rank input, rows 2b body 2 and 1 body 2 at the eight-schools NUTS
    cell's and its twin's final states and phase 2f's input, the HMC rows
    3, 4 dense, 4c and 4b at theirs: ms a launch of
    the package's build, its output digest, its blocks an SM and waves,
    the tail share, each section's
    share of a warp's cycles and the cycles a leaf step (HMC: the wait
    share and the steps a chain, its block's and its own), the n x n
    products (low-rank: velocities) a chain-draw and the fused draw's
    parts around the transition,
    and the clocked build's ptxas lines. Each key names the kernel, the
    metric and the case."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_transition_clocks as tc

    here = Path(__file__).resolve().parents[1]
    out = {}
    for r in tc.run_clocks(root, here / "build", here / "build" / "transition_clocks", only):
        key = f"{r['kernel']}_{r['metric']}_{r['case']}"
        out[f"{key}_ms"] = r["plain_build_ms"]
        out[f"{key}_digest"] = r["digest"]
        if r.get("device_ms") is not None:
            out[f"{key}_device_ms"] = r["device_ms"]
        for k in ("blocks_per_sm", "waves", "tail_share", "span_ms", "block_ms_mean",
                  "block_ms_max",
                  "cycles_per_step",
                  "leaf_steps_per_chain", "leaves_built_per_chain",
                  "mean_leaves_per_chain_draw", "max_depth", "products_per_chain_draw",
                  "velocities_per_chain_draw",
                  "draw_share_outside_transition", "wait_share", "chains_per_block",
                  "lockstep_steps_per_chain_draw", "steps_per_chain_draw", "mean_steps",
                  "max_steps", "block_max_steps_per_draw", "lockstep_step_ratio",
                  *(f"share_{s}" for s in tc.SECTIONS + tc.HMC_SECTIONS),
                  *(f"draw_{x}_{s}" for s in tc.SIDE[:5] for x in ("cycles", "share"))):
            if k in r:
                out[f"{key}_{k}"] = r[k]
        out[f"ptxas_clocks_{r['kernel']}"] = r["ptxas_clocks"]
    return out


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    only = [c for a in sys.argv[1:] if a.startswith("--cases=") for c in a[8:].split(",")]
    root = Path(args[0] if args else Path(__file__).resolve().parents[1])
    states_path = Path(__file__).resolve().parents[1] / "build" / "kernel_ab_states.pt"
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
            model_ms[f"{name}_leaf_ms"] = _leaf_ms(fn, reps=300, warmup=20)
    model_ms.update(_body_times(states_path))
    model_ms.update(_transition_rows(root, only or None))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"root": str(root), "card": smi, "ptxas": ptxas,
                      "nuts_trajectory_diag_ms": traj_ms, "fused_nuts_4_draws_ms": fused_ms,
                      "fused_hmc_4_draws_ms": fused_hmc_ms, **model_ms}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
