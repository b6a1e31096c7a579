#!/usr/bin/env python3
"""Smoke test of littlemcmc_torch on one CUDA card: build, check, run, time.

Run from the root of a checkout, on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, each printing its own lines (every NUTS check of phase 2 launches
the kernel on all its chains and runs the plain version on a quarter of
them, whole chain blocks, every fourth chain of the inputs as made:
``PLAIN_SHARE``):

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
   2b. the same with the dense metric (the true covariance shared by
   every chain; at least 99% agreement);
   2c. the fused multi-draw kernel against its plain version at 1024
   chains, 4 draws: a static draw chunk and an ``adapt_dense`` tune chunk
   across a window swap with the step size held (flags agree on at least
   99% of chain-draws, q within 1e-4 sd, energy within 1e-3, the
   accept statistic, step sizes, log density and energy changes of each
   draw within the limits of ``_held_stat_errors``, the combined block
   Welford state exact in weight, within 1e-4 in mean and 1e-3 in raw
   scatter, against the plain version and a float64 replay), and the
   tune chunk as the main path runs it, step size adapting (its first
   draw tree for tree, stats included, the dual-averaging state against
   the update replayed over the kernel's accept statistics, the Welford
   state against the float64 replay);
   2d. the HMC trajectory kernel against its plain version, one
   transition of 1024 chains at n = 100 (correlated Gaussian) and n = 4
   (standard normal) from stationary inputs with the sampler's jittered
   step counts (accept and divergence agree on at least 99% / all chains;
   q within 1e-4 sd, energies within 1e-3, the accept statistic within
   1e-3 relative, on the chains that agree; body 1 runs the block HMC
   transition, ``runs_hmc_block_transition``);
   2e. the fused HMC kernel against its plain version in the three modes
   of 2c (HMC's chains share no stream, so each is held until its first
   disagreement; the path lengths must agree exactly; its dense instance
   in blocks of 8 runs the block HMC transition);
   2f-2g. the per-draw NUTS and HMC kernels with the eight-schools body
   against their plain versions, 1024 chains (a quarter deep in the
   funnel's neck), at least 99% of chains agreeing; energies of draws far
   from the start's energy, and of divergent ones, held as ``hmc_check``
   and ``_held_stat_errors`` say for ``scaled``;
   2h-2i. the fused NUTS and HMC kernels' diag branch against their plain
   versions, bodies 1 (100-d correlated Gaussian) and 2 (eight schools),
   1024 chains, trees to the path's depth of 10: a draw chunk of 1 draw,
   and a tune chunk of 2 with the per-chain Welford steps (a window swap
   at draw 1) and dual averaging on, its metric and Welford state within
   1e-4 of their scales of a float64 replay of the kernel's trace;
   2j. the batched model kernels against their plain versions at the
   paths' widths, from inputs made with numpy from fixed seeds: row 6,
   ``logistic_logp_grad`` (1024 chains, the 1000 x 25 design of
   BASELINE config 4, positions from the reference posterior; logp rtol
   3e-4 / atol 1e-2, grad rtol 3e-4 / atol 1e-3), and row 5,
   ``quadform_logp_grad`` (1024 chains, n = 100; rtol 2e-4 / atol 1e-4):
   ``tests/test_ops.py``'s tolerances; each timed beside its plain version
   and the library yardstick (PyTorch's own calls for the same function,
   TF32 off), with its launch geometry and the wrapper's host work a call
   (CUDA events around back-to-back calls less the device time);
   2k. the per-draw NUTS kernel with the logistic body (3) against its
   plain version, 1024 chains from the reference posterior: at least 99%
   of chains agree, q within 1e-4 posterior sd, energies (sums over 1000
   rows, 500-700 in size) within 1e-3 of each 100 of their size;
   2l. the logistic body in the fused NUTS, the HMC and the fused HMC
   kernels against their plain versions at 256 chains (a 2-draw draw
   chunk; one HMC transition), as ``fused_check`` and ``hmc_check`` hold
   them;
   2m. the trajectory kernel's low-rank branch against its plain version:
   the spiked Gaussian's body (4) at 1024 chains and the correlated body
   (1, on no cell) at 64, the metric near each model's covariance
   (``_lowrank_metric``); body 4 at kDiag (256 chains) and in the HMC
   kernel (256 chains); the numbers held as in phase 2;
   2n. the fused NUTS and HMC kernels' low-rank branch with body 4 against
   their plain versions at 256 chains: a 2-draw draw chunk, and a 2-draw
   tune chunk with the per-chain Welford steps across a window swap and
   dual averaging on, its variances and Welford state against a float64
   replay, as 2h-2i hold the diag branch; and the fused NUTS kernel's
   kDiag instance with body 4 (the block transition, on no cell), 256
   chains at 2m's step: a 2-draw draw chunk at 2m's positions and a
   2-draw tune chunk with the step held;
   2o-2p. Neal's centred funnel's body (5) in the per-draw NUTS and HMC
   kernels and in the fused kernels' kDiag instance against their plain
   versions at 1024 chains (a quarter starting in the neck, v < -2; the
   fused ones a 2-draw draw chunk and a 2-draw tune chunk), held as
   ``_compare``, ``hmc_check`` and ``fused_check`` hold eight schools: at
   least 99% of chains (chain-draws) agree, energies of divergent and
   far-off trajectories ``scaled`` (float32 ``exp(-v)`` is chaotic in the
   neck);
   2q. the JAX probe matrix's nine models (``models/probe_matrix.py``) and
   ``HierarchicalRegression``, each lowered to a generated body, through
   ``probe_specs`` on the card: one build of ``csrc/autospec_probe.cu``
   with the ten bodies, each within rtol 5e-3 / atol 1e-3 of its plain
   version at the probe's inputs, the seconds printed;
   2r. the generated ``HierarchicalRegression`` body in the per-draw NUTS
   kernel against its plain version (the traced graph, vmapped), 1024
   chains near the reference posterior
   (``tests/hierarchical_reference_moments.json``), as 2k holds the
   logistic body;
   2s. the six fused-kernel capability probes (``csrc/fused_probe.cu``)
   against their plain versions at the JAX probes' tolerances, each timed;
   the cells F1, F2, L1 and L3 (``fuse_draws=None`` electing the fused
   engine) must launch each of the election's five once, and L1-L3 the
   low-rank one once;
3. the main path: ``sample(CorrelatedGaussian(100).logp_grad,
   model_ndim=100, chains=1024, tune=500, draws=1000, random_seed=42)``,
   with the kernel's launch count set to 0 before and read after, and the
   posterior held to the model's known moments;
   3b. the same call with ``init="adapt_full"``: pooled dense adaptation
   on the fused kernel (engine ``fused_dense_pooled``, 12 fused launches,
   no per-draw launch), the same posterior gates and a draw-phase mean
   tree depth of at most 4;
   3c. 3b with ``fuse_draws=False`` (engine ``per_draw_dense_pooled``,
   1500 launches of the trajectory kernel's dense branch), the same gates;
   3d-3f. the same three calls with ``step=HamiltonianMC(model_ndim=100)``:
   1500 launches of the HMC trajectory kernel (``per_draw_diag``), 12 of
   the fused HMC kernel (``fused_dense_pooled``, its final step size
   larger than 3d's), and the ``fuse_draws=False`` twin on the tensor-op
   trajectory (no kernel), each with the posterior gates;
   3g-3j. eight schools (``scripts/bench_suite.py:253-258``, 275-278):
   ``sample(EightSchools().logp_grad, model_ndim=10, chains=10240,
   tune=500, draws=500, target_accept=0.95)`` with NUTS and with
   ``HamiltonianMC``, each on the fused diag engine (4 launches of its
   fused kernel) and with ``fuse_draws=False`` on the per-draw kernel
   (1000 launches), each under the gates of ``_es_quality`` (divergence
   rate < 2% for NUTS, < 1% for HMC; R-hat < 1.05; bulk ESS > 1000; mu and
   log_tau against ``EightSchools.exact_moments``);
   3k. the main path with ``fuse_draws=True``: the fused NUTS kernel's diag
   branch with the correlated body (6 launches), the main path's gates;
   3l. path (A): ``sample(LogisticRegression(use_kernel=True).logp_grad,
   model_ndim=25, chains=1024, tune=200, draws=150, random_seed=42,
   step=NUTS(model_ndim=25, batched_logp_dlogp_func=m.batched_logp_grad,
   trajectory_spec=None))``: the tensor-op tree (``per_draw_diag``,
   trajectory ``tensor``), the logistic kernel launched at every leaf
   (its count read before and after), under ``_logistic_quality``'s gates
   against the reference moments (``tests/logistic_reference_moments.json``);
   3m. path (B): ``sample(LogisticRegression().logp_grad, model_ndim=25,
   chains=1024, tune=500, draws=1000, random_seed=42)``: 1500 launches of
   the per-draw NUTS kernel with the logistic body, the same gates, and
   the two paths' posterior means within 0.1 reference sd of each other;
   3n. T2: ``sample(CorrelatedGaussian(100, use_kernel=True).logp_grad,
   init="jitter+adapt_full", cross_chain_adapt=False, chains=256,
   tune=250, draws=50, max_treedepth=7)``: the tree with a per-chain dense metric
   (``per_draw_dense``), the quadform kernel at every leaf, the main
   path's gates;
   3o-3r. the low-rank cells: ``sample(SpikedGaussian(100).logp_grad,
   model_ndim=100, init="jitter+adapt_lowrank", chains=1024, tune=500,
   draws=1000, random_seed=42)``, pooled at 1024 chains: L1 on the fused
   NUTS kernel (``fused_lowrank_pooled``, 12 launches), L2 with
   ``fuse_draws=False`` (``per_draw_lowrank_pooled``, 1500 launches of the
   trajectory kernel's low-rank branch), L3 with ``HamiltonianMC``
   (``fused_lowrank_pooled`` on the fused HMC kernel), each under the main
   path's gates with every dimension's variance ratio in [0.9, 1.1]; L0,
   the diag contrast (``init="jitter+adapt_diag"``: ``per_draw_diag`` on
   body 4); and the learned-metric gate, L1's min bulk ESS per 1000
   leapfrogs at least 10x L0's;
   3s-3u. F1: ``sample(NealsFunnel(10).logp_grad, model_ndim=10,
   chains=1024, tune=500, draws=1000, target_accept=0.9)`` on
   ``fused_diag`` (6 launches of the fused NUTS kernel with body 5), under
   the JAX suite's envelope (``scripts/bench_suite.py:216-230``: max
   R-hat <= 1.35, divergences off the neck <= 0.025, v's sd >= 2.13,
   divergences <= 0.045), v's quantiles and the neck's share printed;
   F2: the same with ``NonCenteredFunnel(10)`` and the default target
   (``fused_diag`` on body 0): R-hat < 1.05, the standard normal's
   variance, mean, ESS and divergence gates, the funnel-space v sd
   (``transform``) within 10% of 3; H1: ``sample(HierarchicalRegression()
   .logp_grad, model_ndim=42, chains=1024, tune=500, draws=3000,
   target_accept=0.9)``: ``per_draw_diag`` on the generated body (3500
   launches of the trajectory kernel, one probe launch before the first),
   under ``_logistic_quality``'s gates against the reference moments
   (``H1_DRAWS`` says why 3000 draws);
   3v-3y. the rest of the one-card ``sample()`` surface
   (``_surface_cells``): the 100-d main path at 100 + 150 with
   ``checkpoint_every=50``, interrupted by a callback at iteration 150
   and resumed, per draw and with ``fuse_draws=True``, against an
   uninterrupted run's bits, and the checkpoint's save and restore
   seconds; the main path at 50 + 50 inside ``device_trace``, one device
   record for each launch ``perf_report`` counts; ``LinearRegression()``
   and ``StochasticVolatility()`` (T = 128) at 1024 chains, 500 + 1000, on
   their generated bodies (the flat-prior closed form, R-hat and
   divergence gates; the globals' R-hat, divergences and the latent
   path's correlation), and ``StochasticVolatility(T=500)`` declining to
   the tree for 10 + 10 draws (``SV_BIG_CHAINS``, ``SV_BIG_DEPTH``),
   ungated;
4. the kernel's time per launch at the main path's final state beside its
   plain version's time and its bound, where 50 more draws from that
   state spend their device time (``torch.profiler``); each kernel's
   ``ms`` is its device time per launch under the profiler, and
   ``events_ms`` the CUDA events' time around back-to-back calls of its
   wrapper, which for a kernel shorter than the wrapper's host work also
   counts the card waiting for the host;
   4b. the fused kernel's time per 250-draw launch at 3b's final state,
   per draw, its bound, and where one draw chunk spends its device time;
   the 3b call once more under ``torch.profiler``, the fused kernel's
   device time launch by launch; the dense trajectory kernel's time at
   3c's final state;
   4c-4d. the same for the HMC kernels at 3d's and 3e's final states,
   and the 3e call under ``torch.profiler``;
   4e. the eight-schools kernels: the per-draw ones at 2f-2g's inputs and
   at the twins' final states, the fused kDiag instances per 250-draw
   chunk at the fused paths' final states, the eight-schools calls and
   the 3k call under ``torch.profiler``;
   4f. where a draw of paths (A) and (B) spends its time (``_breakdown``:
   20 and 50 draws from the paths' final states under the profiler), the
   trajectory kernel's logistic body at path (B)'s final state, and the
   HMC kernel's at 2l's input;
   4g. the low-rank kernels (``_lowrank_timing``): the trajectory kernel's
   low-rank branch at L2's final state, body 4 at kDiag at 2m's input and
   L0's final state, body 4 in the HMC kernel at 2m's input, the fused
   kernels' low-rank branch at 2n's draw-chunk input and per 250-draw
   chunk at L1's and L3's final states; where L1, L3 and a post-tune draw
   of L2 spend their time;
   4h. the funnel body's kernels at F1's final state (the fused kDiag
   instance per 250-draw chunk, the per-draw kernel per launch), the
   generated body in ``nuts_trajectory`` per launch at H1's final state
   (with where its scratch rows were placed: ``scratch_in_smem``),
   the tensor-op tree on the same model (ms a draw over 20 draws from that
   state, the number the generated body exists to beat) beside 50 draws
   on the generated body, and the probe kernel alone;
   4i. the two new generated bodies in ``nuts_trajectory`` at their
   cells' final states against their plain versions, per launch, with
   their ptxas lines (``_surface_rows``); then the ptxas
   lines of the per-draw and fused NUTS kernels' body-2, body-4 and body-5
   diag instances, body-1 dense and body-4 low-rank instances (those on
   the block transition beside those on the warp transition) and of the
   HMC kernels' body-1 instances on the block HMC transition (per draw,
   whose warp instance is not compiled, and the fused dense one beside its
   warp instance) and of the fused HMC kernel's register instances (body
   4 low-rank beside its warp instance, eight schools' packed one, whose
   warp instance is not compiled), and one JSON
   line of kernel rows (each NUTS row's ``transition``, ``block`` or
   ``warp``: the transition of ``csrc/nuts_transition.cuh`` its instance
   runs, and each HMC row's, ``block`` for the block HMC transition of
   ``csrc/hmc_transition.cuh``, for the fused HMC kernel also
   ``registers`` (row 4c, the low-rank instance) or ``packed`` (row 4b,
   eight schools), ``fused_hmc_transition``; the main HMC rows' ``blocks_per_sm``; the
   eight-schools NUTS rows' ``blocks_per_sm``, the blocks of their launch
   at 10,240 chains that fit on an SM), the six fused probes
   last (for the fused kernels ``ms``, ``plain_ms`` and ``bound_ms`` are
   one launch on 2c's, 2e's, 2h's, 2i's or 2p's draw-chunk input: 4
   draws, in 2h-2i 1, in 2p 2; ``chunk_*`` the 250-draw launch; for the
   eight-schools per-draw rows ``main_*`` one launch at 10,240 chains).

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
# eight schools at the north star's chain count (scripts/bench_suite.py:253-258)
ES_CHAINS, ES_TUNE, ES_DRAWS, ES_TARGET = 10240, 500, 500, 0.95
# logistic regression, BASELINE config 4 (scripts/bench_suite.py:250-252):
# 25 parameters, 1000 data rows, at the main path's chains and draws; on
# the tensor-op tree (path A) cut to 200 + 150: the tree takes 1.2-1.9 ms
# a leaf, with the host's speed; 500 + 500 took 138-205 s, 300 + 200
# 67-160 s, 200 + 200 80-100 s, and the script's 1200 s need the room.
# Its R-hat gate needs the draws: 1.0058 at 200, 1.012 (failed) at 100
LG_N, LG_ROWS, LG_TUNE, LG_DRAWS = 25, 1000, 500, 1000
LG_TREE_TUNE, LG_TREE_DRAWS = 200, 150
# the tree with a per-chain dense metric and the quadform kernel (T2),
# cut to 250 + 50 for the script's time (500 + 250 took 190-300 s,
# 300 + 150 96-198 s, 250 + 100 117-160 s); its gates hold no R-hat, and
# 256 x 50 draws keep its bulk ESS far above 1000. Its trees to depth 7:
# the tree runs a leaf for all 256 chains while any builds, 243 leaves a
# draw at depth 10 (the deepest 9, the mean 5.8 in 164 s)
T2_CHAINS, T2_TUNE, T2_DRAWS, T2_DEPTH = 256, 250, 50, 7
# the logistic posterior's reference moments, from a long run of the JAX
# package on a CPU (tests/test_torch_logistic.py writes them)
REFERENCE = ROOT / "tests" / "logistic_reference_moments.json"
# the hierarchical regression's, from a long run of the JAX package on a CPU
# (tests/test_torch_autospec.py writes them)
HIER_REFERENCE = ROOT / "tests" / "hierarchical_reference_moments.json"
# H1's draws: the bench suite's 500 + 1000 (scripts/bench_suite.py:259-265)
# give each chain about 55 effective draws, and a split R-hat of chains that
# short sits near 1 + 1/(2 x 27.5): 1.0158 here, 1.0163 in the JAX suite's
# own run of this cell (BENCH_SUITE.json). 3000 draws bring it near 1.005,
# under the cell's 1.01 gate
H1_DRAWS = 3000
# the sample() surface (3v-3w): checkpoint/resume on the 100-d main path,
# 100 + 150 draws, a checkpoint every 50, interrupted at iteration 150 by a
# callback and resumed; the main path at 50 + 50 inside device_trace
CK_TUNE, CK_DRAWS, CK_EVERY, CK_STOP = 100, 150, 50, 150
TR_TUNE, TR_DRAWS = 50, 50
# the generated-body models (3x-3y): linear regression and stochastic
# volatility at T = 128 (131 parameters) at the main path's chains and
# draws; T = 500 (scripts/bench_suite.py:266-274, 503 parameters) declines
# to the tree and runs 10 + 10 draws there, ungated, at the suite's own
# quarter scale of its chains (1024 // 4) and trees to depth 8 (the early
# tuning cap): at 1024 chains and depth 10 its 20 draws took 50.7 s (2.5 s
# a draw, 527 leaves), at 256 chains 43.6 s (558 leaves), of the script's
# time. The stochastic-volatility body's plain version runs on a
# sixteenth of the chains (35.4 s on a quarter)
SV_TARGET, SV_BIG_T, SV_BIG_TUNE, SV_BIG_DRAWS, SV_BIG_CHAINS = 0.95, 500, 10, 10, 256
SV_BIG_DEPTH = 8
SV_PLAIN_SHARE = 16
DEVICE = "cuda"  # where the checks' inputs are made: the card
FLAGS = ("depth", "n_leaves", "diverging", "turning")
HMC_FLAGS = ("n_steps", "accepted", "diverging")
Q_TOL_SD, E_TOL = 1e-4, 1e-3  # kernel vs plain, on the chains that agree
# The NUTS checks' plain versions run on the first 1 / PLAIN_SHARE of the
# chains (whole chain blocks, _plain_chains): they step their blocks one
# after another in Python, so their time grows with the blocks they run,
# and at every chain took 347 s of the script's 1075 s on an H100 (700 W
# power limit). The kernel's
# launch still covers every chain at the path's shapes.
PLAIN_SHARE = 4
# what the fused ops' checks hold, by step method: the decisions that must
# agree, the per-draw energies (within E_TOL), the accept statistic that
# feeds dual averaging (within ACCEPT_REL * E_TOL relative: NUTS's averages
# leaves, each off by at most the error of its energy change) and the
# count of work units (leaves, leapfrog steps)
FUSED_STEPS = {
    "nuts": dict(flags=FLAGS, energies=("model_logp", "energy_error", "max_energy_change"),
                 accept="mean_tree_accept", accept_rel=2.0, work="n_leaves"),
    "hmc": dict(flags=HMC_FLAGS, energies=("model_logp", "energy_error", "energy"),
                accept="accept", accept_rel=1.0, work="n_steps"),
}


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


def _device_ms(fn, name: str, reps: int, fallback_ms: float = None) -> tuple[float, str]:
    """Mean device milliseconds of one launch of the kernel whose name
    holds ``name``, over ``reps`` calls of ``fn`` inside
    :func:`~littlemcmc_torch.utils.profiling.device_trace`: the kernel's
    own time, without the gaps in which the card waits for the host's next
    launch, which CUDA events around a kernel shorter than its Python
    wrapper also count. A window whose trace lost a launch's device record
    is taken again, up to three windows; where none kept every record, the
    mean is over the records of the window that kept the most. Returns
    ``(ms, source)``: ``"profiler"``, or ``"profiler:"`` and each window's
    records of ``reps``; raises where no window kept one (``fallback_ms``
    is not used: no row falls back to events)."""
    import tempfile

    import torch
    from littlemcmc_torch.utils.profiling import device_trace

    del fallback_ms
    fn()
    torch.cuda.synchronize()
    kept, best = [], (0, 0.0)
    for _ in range(3):
        with tempfile.TemporaryDirectory() as d:
            with device_trace(d, check=False) as tr:
                for _ in range(reps):
                    fn()
        hits = [e for e in tr.profiler.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key]
        kept.append(sum(e.count for e in hits))
        if kept[-1] > reps:
            raise RuntimeError(f"{name}: {kept[-1]} device records of {reps} launches: the "
                               f"name matches another kernel")
        best = max(best, (kept[-1], sum(e.self_device_time_total for e in hits)))
        if kept[-1] == reps:
            break
    if best[0] == 0:
        raise RuntimeError(f"{name}: the profiler kept no device record of {reps} launches "
                           f"in three windows")
    src = "profiler" if kept == [reps] else "profiler:" + ",".join(f"{k}/{reps}" for k in kept)
    return best[1] / best[0] / 1e3, src


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
    dev = torch.device(DEVICE)
    qt = torch.from_numpy(q).to(dev)
    logp, grad = model.batched_logp_grad(qt)
    return (qt, torch.from_numpy(p).to(dev), grad.contiguous(), logp.contiguous(),
            torch.from_numpy(eps).to(dev),
            torch.full((C,), DEPTH, dtype=torch.int32, device=dev),
            torch.from_numpy(var).to(dev))


def _dense_stationary_inputs(model, C, eps, seed):
    """As :func:`_stationary_inputs` for the dense metric: the true
    covariance shared by every chain, q ~ N(0, cov), p ~ N(0, cov^-1)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n = model.ndim
    chol = np.linalg.cholesky(model.cov)
    q = (rng.standard_normal((C, n)) @ chol.T).astype(np.float32)
    p = np.ascontiguousarray(np.linalg.solve(chol.T, rng.standard_normal((n, C))).T,
                             dtype=np.float32)
    eps = (eps * rng.uniform(0.8, 1.2, C)).astype(np.float32)
    dev = torch.device(DEVICE)
    qt = torch.from_numpy(q).to(dev)
    logp, grad = model.batched_logp_grad(qt)
    return (qt, torch.from_numpy(p).to(dev), grad.contiguous(), logp.contiguous(),
            torch.from_numpy(eps).to(dev),
            torch.full((C,), DEPTH, dtype=torch.int32, device=dev),
            torch.from_numpy(model.cov.astype(np.float32)).to(dev))


def _reference() -> dict:
    """The logistic regression's reference posterior moments (``mean``,
    ``sd``, ``mcse_mean``: 25 each)."""
    return json.loads(REFERENCE.read_text())


def _hier_reference() -> dict:
    """The hierarchical regression's reference posterior moments (42 each)."""
    return json.loads(HIER_REFERENCE.read_text())


def _logistic_moments(model):
    """The logistic posterior's means and sds: the reference's for
    BASELINE config 4's 1000 x 25 design, else a Laplace approximation
    (float64 on the host: the mode by Newton's method, the sds from the
    inverse Hessian there)."""
    import numpy as np

    if tuple(model.Xb.shape) == (LG_ROWS, LG_N):
        ref = _reference()
        return np.array(ref["mean"]), np.array(ref["sd"])
    X = model.Xb.double().cpu().numpy()
    y = model.y.double().cpu().numpy()
    prec = float(model.prior_prec[0])
    beta = np.zeros(X.shape[1])
    for _ in range(50):
        s = 1.0 / (1.0 + np.exp(-X @ beta))
        hess = (X * (s * (1.0 - s))[:, None]).T @ X + prec * np.eye(len(beta))
        step = np.linalg.solve(hess, X.T @ (y - s) - prec * beta)
        beta += step
        if np.abs(step).max() < 1e-10:
            break
    return beta, np.sqrt(np.diag(np.linalg.inv(hess)))


def _posterior_sd(model):
    """The posterior sd of each parameter: exact for the Gaussians; for
    eight schools the exact sds of mu and log_tau and 1 for theta_tilde,
    the scale its prior gives them; for the logistic regression
    :func:`_logistic_moments`'."""
    import numpy as np

    if hasattr(model, "true_var"):
        return np.sqrt(model.true_var)
    if hasattr(model, "n_groups"):
        return np.array(_hier_reference()["sd"])
    if not hasattr(model, "exact_moments"):
        return _logistic_moments(model)[1]
    m = model.exact_moments()
    return np.array([m["mu"][1], m["log_tau"][1]] + [1.0] * 8)


def _positions(model, rng, C):
    """Positions spread like the posterior, float32 ``(C, n)``: the
    Gaussians' exactly; eight schools' by :func:`_es_positions`; the
    logistic regression's from :func:`_logistic_moments`."""
    import numpy as np

    if hasattr(model, "scales"):
        return model.draws(rng.standard_normal((C, model.ndim)))
    if hasattr(model, "cov"):
        return (rng.standard_normal((C, model.ndim)) @ np.linalg.cholesky(model.cov).T
                ).astype(np.float32)
    if hasattr(model, "n_groups"):
        ref = _hier_reference()
        return (np.array(ref["mean"]) + np.array(ref["sd"])
                * rng.standard_normal((C, model.ndim))).astype(np.float32)
    if model.trajectory_spec().body == "funnel":
        return _funnel_positions(rng, C, model.ndim, model.scale)
    if model.trajectory_spec().body == "logistic":
        mean, sd = _logistic_moments(model)
        return (mean + sd * rng.standard_normal((C, model.ndim))).astype(np.float32)
    return _es_positions(rng, C)


def _funnel_positions(rng, C, n=10, scale=3.0):
    """Centred-funnel positions spread like the posterior, a quarter of
    the chains in the neck (v in [-6, -2]): v ~ N(0, scale), x ~ N(0,
    exp(v/2))."""
    import numpy as np

    v = rng.normal(0.0, scale, C)
    v[: C // 4] = rng.uniform(-6.0, -2.0, C // 4)
    x = rng.standard_normal((C, n - 1)) * np.exp(v / 2.0)[:, None]
    return np.concatenate([v[:, None], x], 1).astype(np.float32)


def _es_positions(rng, C):
    """Eight-schools positions spread like the posterior, a quarter of the
    chains deep in the funnel's neck (log_tau <= -8)."""
    import numpy as np

    q = np.concatenate([rng.normal(4.5, 3.2, (C, 1)), rng.normal(-2.7, 3.4, (C, 1)),
                        rng.standard_normal((C, 8))], 1).astype(np.float32)
    q[: C // 4, 1] = rng.uniform(-12.0, -8.0, C // 4)
    return q


def _posterior_inputs(model, C, eps, seed):
    """The trajectory inputs of :func:`_stationary_inputs` for eight
    schools and the logistic regression: positions of :func:`_positions`,
    an inverse-mass diagonal near the posterior variances, p ~ N(0, M)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n = model.ndim
    q = _positions(model, rng, C)
    var = (_posterior_sd(model) ** 2 * rng.uniform(0.5, 2.0, (C, n))).astype(np.float32)
    p = (rng.standard_normal((C, n)) / np.sqrt(var)).astype(np.float32)
    eps = (eps * rng.uniform(0.7, 1.3, C)).astype(np.float32)
    dev = torch.device(DEVICE)
    qt = torch.from_numpy(q).to(dev)
    logp, grad = model.batched_logp_grad(qt)
    return (qt, torch.from_numpy(p).to(dev), grad.contiguous(), logp.contiguous(),
            torch.from_numpy(eps).to(dev),
            torch.full((C,), DEPTH, dtype=torch.int32, device=dev),
            torch.from_numpy(var).to(dev))


def _lowrank_metric(model):
    """A low-rank metric near a Gaussian's covariance: ``(scales, V, lam,
    alpha)``. The spiked Gaussian's own (its scales and spikes, the bulk
    1, which is exact); else the scales ``sqrt(diag cov)`` and the top 8
    eigenpairs of the correlation matrix with the rest's mean as the
    bulk."""
    import numpy as np

    if hasattr(model, "scales"):
        return model.scales, model.V, model.lam, 1.0
    s = np.sqrt(np.diag(model.cov))
    w, U = np.linalg.eigh(model.cov / np.outer(s, s))
    rest = w[::-1][8:]
    return s, U[:, ::-1][:, :8], w[::-1][:8], float(rest.mean()) if rest.size else 1.0


def _model_fac(model, device):
    """The factor block of :func:`_lowrank_metric`."""
    import torch
    from littlemcmc_torch.ops.nuts_trajectory import build_lowrank_fac

    _, V, lam, alpha = _lowrank_metric(model)
    f = dict(dtype=torch.float32, device=device)
    return build_lowrank_fac(torch.tensor(V.copy(), **f), torch.tensor(lam.copy(), **f),
                             torch.tensor(alpha, **f))


def _lowrank_inputs(model, C, eps, seed):
    """Trajectory inputs for the low-rank metric of :func:`_lowrank_metric`:
    positions of :func:`_positions`, the scales off by up to 25% per chain,
    momenta ``p = S⁻¹(α^{-1/2} z + V((lam^{-1/2} - α^{-1/2}).(Vᵀz)))`` of
    that metric. Returns the trajectory's arguments, the chains' scales as
    ``var``, and the factor block."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n = model.ndim
    scales, V, lam, alpha = _lowrank_metric(model)
    q = _positions(model, rng, C)
    stds = (scales * rng.uniform(0.8, 1.25, (C, n))).astype(np.float32)
    z = rng.standard_normal((C, n))
    p = ((alpha ** -0.5 * z + ((z @ V) * (lam ** -0.5 - alpha ** -0.5)) @ V.T) / stds
         ).astype(np.float32)
    eps = (eps * rng.uniform(0.8, 1.2, C)).astype(np.float32)
    dev = torch.device(DEVICE)
    qt = torch.from_numpy(q).to(dev)
    logp, grad = model.batched_logp_grad(qt)
    return (qt, torch.from_numpy(p).to(dev), grad.contiguous(), logp.contiguous(),
            torch.from_numpy(eps).to(dev),
            torch.full((C,), DEPTH, dtype=torch.int32, device=dev),
            torch.from_numpy(stds).to(dev)), _model_fac(model, dev)


def _plain_chains(C: int, share: int, cb: int = CHAIN_BLOCK) -> int:
    """The chains a check's plain version runs: the first ``C / share``,
    whole chain blocks of ``cb`` (at least one). A chain block's counter
    stream, trees and outputs depend on no other block (and a block's
    pooled Welford seed on the count of blocks only through a power of two
    here, :func:`_plain_inputs`), so the plain version's blocks are the
    kernel launch's first blocks, bit for bit in their inputs."""
    m = max(cb, C // share // cb * cb)
    ratio = C // m
    if C % m or ratio & (ratio - 1):
        raise ValueError(f"{C} chains in blocks of {cb}: a plain version on {m} of them "
                         "is not a power-of-two share of whole blocks")
    return m


def _spread(args, kw, C: int, share: int, shared=()):
    """The op's inputs with the chains reordered so that the first ``C /
    share`` of them, the plain version's, are every ``share``-th chain of
    the given order: inputs that keep some kind of chain in a range of
    rows (a quarter of the funnel's and of eight schools' chains in the
    neck, the first quarter) keep its share among the chains the plain
    version runs. Per-chain tensors and Welford rows move; those at the
    positions ``shared`` stay."""
    import torch

    if share == 1:
        return args, kw
    perm = torch.arange(C).reshape(C // share, share).T.reshape(-1)
    pick = lambda a: a[perm.to(a.device)]  # noqa: E731
    args = tuple(pick(a) if (a is not None and i not in shared) else a
                 for i, a in enumerate(args))
    kw = dict(kw)
    if kw.get("welford") is not None:
        kw["welford"] = tuple(pick(w) for w in kw["welford"])
    return args, kw


def _plain_inputs(args, kw, m: int, C: int, shared=()):
    """The op's arguments and keywords for its plain version on the first
    ``m`` of ``C`` chains: every per-chain tensor's first ``m`` rows (those
    at the positions ``shared``, the metric shared by every chain, whole),
    the per-chain Welford state's too, and the pooled dense Welford state's
    weights and raw scatters scaled by ``m / C``, so that each of the plain
    version's ``m / cb`` blocks is seeded with what each of the kernel's
    ``C / cb`` blocks is (1/B of the global state; a power-of-two scale,
    exact in float32)."""
    pargs = tuple(a[:m] if (a is not None and i not in shared) else a
                  for i, a in enumerate(args))
    pkw = dict(kw)
    if kw.get("welford") is not None:
        pkw["welford"] = tuple(w[:m] for w in kw["welford"])
    if kw.get("dense_welford") is not None:
        r = m / C
        fgm, fgr, fgw, bgm, bgr, bgw, ns, pu, win = kw["dense_welford"]
        pkw["dense_welford"] = (fgm, fgr * r, fgw * r, bgm, bgr * r, bgw * r, ns, pu, win)
    return pargs, pkw


def _first_chains(out, m: int, C: int, T: int, cb: int):
    """The first ``m`` of ``C`` chains of a fused op's outputs: the trace's
    and per-draw stats' ``(T, C)`` columns, per-chain rows, the first
    ``m / cb`` blocks' pooled Welford states; shared counters whole."""
    import torch

    sub = {}
    for k, v in out.items():
        if not torch.is_tensor(v) or v.dim() == 0:
            sub[k] = v
        elif k.startswith("dense_"):
            sub[k] = v[:m // cb]
        elif v.dim() >= 2 and tuple(v.shape[:2]) == (T, C):
            sub[k] = v[:, :m]
        elif v.shape[0] == C:
            sub[k] = v[:m]
        else:
            sub[k] = v
    return sub


def _held(agree, cb=CHAIN_BLOCK):
    """Per (draw, chain) of a ``(T, C)`` flag agreement: every chain of the
    chain's block agreed at this draw and all earlier ones. One chain's
    other decision changes its block's shared counter stream, so only
    these chains are held number for number. ``cb=1``: the chain itself
    (HMC's chains share no stream)."""
    import torch

    block = agree.reshape(agree.shape[0], -1, cb).all(-1)
    return torch.cumprod(block.to(torch.int32), 0).bool().repeat_interleave(cb, 1)


def _compare(name, model, args, seed, need, metric="diag", fac=None, share=1, sd=None):
    """One kernel launch against the plain version on the same inputs
    (the dense metric: numbers held on the chains whose block agreed), q
    in units of the model's posterior sd (:func:`_posterior_sd`); ``fac``
    the low-rank metric's factor block; ``share``: the plain version runs
    on the first 1 / ``share`` of the chains (:func:`_plain_chains`; the
    inputs' chains reordered so that those are every ``share``-th,
    :func:`_spread`), on which the kernel's launch over every chain is
    held; ``sd``: the posterior sds, where :func:`_posterior_sd` does not
    know the model."""
    import numpy as np
    import torch
    from littlemcmc_torch.ops.nuts_trajectory import trajectory, trajectory_plain

    kw = dict(spec=model.trajectory_spec(), max_treedepth=DEPTH, Emax=1000.0,
              chain_block=CHAIN_BLOCK, metric=metric, fac=fac)
    C = args[0].shape[0]
    m = _plain_chains(C, share)
    shared = (6,) if metric == "dense" else ()
    args, _ = _spread(args, {}, C, share, shared)
    got = trajectory(*args, seed, **kw)
    torch.cuda.synchronize()
    pargs, _ = _plain_inputs(args, {}, m, C, shared)
    got = {k: v[:m] for k, v in got.items()}
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want = trajectory_plain(*pargs, seed, **kw)
    end.record()
    end.synchronize()
    agree = torch.stack([got[k] == want[k] for k in FLAGS]).all(0)
    share = float(agree.float().mean())
    if metric != "diag":
        agree = _held(agree[None])[0]
    errs = {}
    for k in ("q", "grad", "energy"):
        d = (got[k] - want[k])[agree].abs()
        rel = d / want[k][agree].abs().clamp_min(1e-6)
        errs[f"{k}_max_abs"] = float(d.max())
        errs[f"{k}_max_rel"] = float(rel.max())
    sd = torch.from_numpy(np.asarray(_posterior_sd(model) if sd is None else sd)
                          ).float().to(got["q"].device)
    errs["q_max_err_in_sd"] = float(((got["q"] - want["q"]).abs() / sd)[agree].max())
    # E_TOL is set for energies about 100 in size; the logistic body's are
    # sums over 1000 data rows, 500-700 in size, held in proportion
    e_size = (torch.clamp(want["energy"].abs() / 100.0, min=1.0)
              if model.trajectory_spec().body in ("logistic", "auto")
              else torch.ones_like(want["energy"]))
    errs["energy_max_in_tol"] = float(((got["energy"] - want["energy"]).abs()
                                       / (E_TOL * e_size))[agree].max())
    print(json.dumps({"phase": "kernel_vs_plain", "model": name, "metric": metric,
                      "chains": C, "plain_chains": m,
                      "ndim": args[0].shape[1], "agree_share": share,
                      "mean_depth": float(want["depth"].float().mean()),
                      "mean_leaves": float(want["n_leaves"].float().mean()),
                      "plain_ms": start.elapsed_time(end), **errs}), flush=True)
    if share < need:
        raise RuntimeError(f"{name}: kernel and plain version agree on {share:.4f} "
                           f"of chains, need {need}")
    # fp32 rounding of two summation orders, carried through up to 2^10
    # leapfrog steps: proposals within Q_TOL_SD posterior sds, energies
    # (about n in size) within E_TOL, the logistic body's within E_TOL of
    # each 100 of their size
    if errs["q_max_err_in_sd"] > Q_TOL_SD or errs["energy_max_in_tol"] > 1.0:
        raise RuntimeError(f"{name}: kernel and plain version differ by "
                           f"{errs['q_max_err_in_sd']} sd in q (limit {Q_TOL_SD}) and "
                           f"{errs['energy_max_abs']} in energy ({errs['energy_max_in_tol']} "
                           f"of the limit)")
    return errs["q_max_abs"], start.elapsed_time(end)


def _ptxas_entries(log: str) -> dict:
    """ptxas's lines (``-Xptxas -v``) of each entry function of a build
    log: its mangled name -> its stack-frame and register lines."""
    out, entry = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
            out[entry] = []
        elif entry is not None and ("stack frame" in ln or "registers" in ln):
            out[entry].append(ln.strip())
    return out


def _hmc_moved_instances(log: str) -> dict:
    """The ptxas lines (``_ptxas_entries``) of the HMC kernels' redesigned
    instances, keyed ``<body,metric,transition>``: body 1's per-draw block
    instance (diag), the fused kernel's dense block instance
    (``fused_hmc_kernel<1,1,true>``) and its warp instance, the fused
    kernel's low-rank register instance (``fused_hmc_lowrank_kernel<4>``)
    and its warp instance (``fused_hmc_kernel<4,2,false>``), and eight
    schools' packed instance (``fused_hmc_packed_kernel<2>``); another
    instance is left out."""
    import re

    moved = {}
    for entry, lines in _ptxas_entries(log).items():
        m = re.search(r"\d+(hmc_trajectory_block_kernel|fused_hmc_kernel|"
                      r"fused_hmc_lowrank_kernel|fused_hmc_packed_kernel)"
                      r"ILi(\d+)E(?:Li(\d+)E)?(?:Lb(\d)E)?", entry)
        if m is None:
            continue
        kind, body, metric = m.group(1), m.group(2), m.group(3)
        if kind == "fused_hmc_kernel" and (body, metric) in (("1", "1"), ("4", "2")):
            block = m.group(4) == "1"
            moved[f"<{body},{metric},{'block' if block else 'warp'}>"] = lines
        elif kind == "hmc_trajectory_block_kernel" and body == "1":
            moved["<1,0,block>"] = lines
        elif kind == "fused_hmc_lowrank_kernel":
            moved[f"<{body},2,registers>"] = lines
        elif kind == "fused_hmc_packed_kernel":
            moved[f"<{body},0,packed>"] = lines
    return moved


def _roofline_ms(ops: float, nbytes: float) -> tuple[float, str]:
    """The least time for ``ops`` fp32 operations and ``nbytes`` of device
    memory traffic on this card, in ms, and which of the two bounds it."""
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _body_ops(body: str, n: int, rows: int = 0, ir_ops: int = 0) -> int:
    """Operations of one evaluation of a model body: the correlated
    Gaussian's 2n^2-FLOP matvec, eight schools' about 15n (the theta
    lanes, four warp sums and an exp), the standard normal's 2n, the
    logistic regression's two products over ``rows`` data rows (4 rows n)
    and about 8 operations a row for the softplus, the sigmoid and the
    log likelihood (an exponential counted as one); the funnel's about 6n
    (the sum of squares, the gradient and an exp); a generated body's
    ``ir_ops``, its program's operations (``Program.flops``)."""
    if body == "spiked_gaussian":  # two thin matvecs of k = rows columns
        return 4 * rows * n + 5 * n
    if body == "auto":
        return ir_ops
    if body == "funnel":
        return 6 * n
    return {"correlated_gaussian": 2 * n * n, "eight_schools": 15 * n,
            "standard_normal": 2 * n, "logistic": 4 * rows * n + 8 * rows}[body]


def _body_consts(body: str, n: int, rows: int = 0) -> int:
    """Floats of a model body's constants, each read once (a generated
    body's: ``rows``)."""
    return {"correlated_gaussian": n * n, "eight_schools": 2 * n, "funnel": 1, "auto": rows,
            "logistic": rows * n + rows + 1, "spiked_gaussian": rows * (n + 1) + n}.get(body, 0)


# operations of the low-rank metric's velocity and momentum for a factor of
# rank k (the kernels pad it to 8 columns of zeros, work the function does
# not need): two thin matvecs and the elementwise scalings
def _lowrank_velocity_ops(n: int, k: int) -> int:
    return 4 * k * n + 5 * n


def _lowrank_fac_floats(n: int, k: int) -> int:
    return k * (n + 2) + 2


def _fac_rank(fac, n: int) -> int:
    """The rank of a factor block: its columns of V that are not padding."""
    from littlemcmc_torch.ops.nuts_trajectory import lowrank_fac_parts

    return int((lowrank_fac_parts(fac, n)[0] != 0).any(1).sum())


def _logistic_bound_ms(C: int, n: int, rows: int) -> tuple[float, str]:
    """Least time for one batched logistic evaluation (row 6): the body's
    operations and 4n an chain for the prior and the gradient's epilogue;
    q and the constants read once, logp and grad written once."""
    ops = C * (_body_ops("logistic", n, rows) + 4 * n)
    return _roofline_ms(ops, 4 * (C * n + _body_consts("logistic", n, rows)) + 4 * (C + C * n))


def _quadform_bound_ms(C: int, n: int) -> tuple[float, str]:
    """Least time for one batched quadform evaluation (row 5): 2 C n^2 for
    the product and 3 C n for the epilogue; q and the precision read once,
    logp and grad written once."""
    return _roofline_ms(2 * C * n * n + 3 * C * n, 4 * (C * n + n * n) + 4 * (C + C * n))


def _bound_ms(n_leaves_total: int, C: int, n: int, metric: str = "diag",
              body: str = "correlated_gaussian", rows: int = 0,
              rank: int = 0, ir_ops: int = 0) -> tuple[float, str]:
    """Least time for one transition: per leaf and chain the model body
    (plus one velocity: the dense metric's 2n^2-FLOP matvec, the low-rank
    metric's two thin matvecs of its ``rank`` columns) and about 20n
    elementwise operations, plus the proposal's gradient (and the start
    energy's velocity); the inputs (the low-rank metric: the scales and
    the factor block) read once and the outputs written once."""
    vel = {"dense": 2 * n * n, "lowrank": _lowrank_velocity_ops(n, rank)}.get(metric, 0)
    per_leaf = vel + _body_ops(body, n, rows, ir_ops) + 20 * n
    ops = n_leaves_total * per_leaf + C * (_body_ops(body, n, rows, ir_ops) + 2 * n) + C * vel
    var_floats = {"dense": n * n,
                  "lowrank": C * n + _lowrank_fac_floats(n, rank)}.get(metric, C * n)
    consts = _body_consts(body, n, rows)
    nbytes = (4 * (3 * C * n + var_floats + 3 * C + consts) + 4 * (2 * C * n + 7 * C)
              + 2 * C)
    return _roofline_ms(ops, nbytes)


def _fused_bound_ms(n_leaves_total: int, C: int, n: int, T: int,
                    tuning: bool) -> tuple[float, str]:
    """Least time for one fused launch of ``T`` draws: per chain and draw
    2n^2 FLOP for the momentum, 2n^2 for the final gradient and, in tune,
    4n^2 for the Welford adds; per leaf 2n^2 for the model body, 2n^2 for
    the velocity and about 20n elementwise; against the state, metric and
    precision read once and the trace and 11 stats of each draw written
    once."""
    ops = (n_leaves_total * (4 * n * n + 20 * n)
           + C * T * (4 * n * n + (4 * n * n if tuning else 0)))
    nbytes = 4 * (2 * C * n + 8 * C + 3 * n * n) + 4 * (T * C * n + 11 * T * C + 2 * C * n)
    return _roofline_ms(ops, nbytes)


def _fused_inputs(model, C, seed, iter_count=300.0, log_step=-0.7):
    """Fused-op inputs at stationarity: q ~ N(0, cov), the true covariance
    as the metric with L^-1 from its Cholesky factor, step sizes near
    exp(log_step), dual averaging part way through."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    dev = torch.device(DEVICE)
    f = dict(dtype=torch.float32, device=dev)
    n = model.ndim
    chol = np.linalg.cholesky(model.cov)
    q = torch.from_numpy((rng.standard_normal((C, n)) @ chol.T).astype(np.float32)).to(dev)
    logp, grad = model.batched_logp_grad(q)
    ls = torch.from_numpy((log_step + rng.uniform(-0.1, 0.1, C)).astype(np.float32)).to(dev)
    cov = torch.from_numpy(model.cov.astype(np.float32)).to(dev)
    linv = torch.linalg.solve_triangular(torch.linalg.cholesky(cov),
                                         torch.eye(n, **f), upper=False)
    return (q, grad.contiguous(), logp.contiguous(), torch.full((C,), iter_count, **f), ls,
            ls.clone(), torch.zeros(C, **f), torch.full((C,), 40.0, **f), ls + np.log(10.0),
            cov, linv)


def _welford_seed(model):
    """A global pooled dense Welford state whose windows swap at draw 2 of
    a chunk (n_samples 200, prev_update 101, window 101)."""
    import torch

    f = dict(dtype=torch.float32, device=torch.device(DEVICE))
    n = model.ndim
    cov = torch.from_numpy(model.cov).to(**f)
    return (torch.zeros(n, **f), cov * 5000.0, torch.tensor(5000.0, **f),
            torch.full((n,), 0.01, **f), cov * 900.0, torch.tensor(900.0, **f),
            torch.tensor(200.0, **f), torch.tensor(101.0, **f), torch.tensor(101.0, **f))


def _replay_welford(welford, trace, mult=2.0):
    """The pooled Welford bookkeeping in float64: each draw's positions of
    every chain join both windows, then the shared swap."""
    import torch

    fgm, fgr, fgw, bgm, bgr, bgw, ns, pu, win = (w.double() for w in welford)
    fg, bg = [fgw, fgm, fgr], [bgw, bgm, bgr]
    for x in trace.double():
        xm = x.mean(0)
        xc = x - xm
        for w_ in (fg, bg):
            W, m, r = w_
            Wn = W + x.shape[0]
            d = xm - m
            w_[:] = [Wn, m + d * (x.shape[0] / Wn),
                     r + xc.T @ xc + (W * x.shape[0] / Wn) * torch.outer(d, d)]
        if ns - pu >= win:
            fg, bg = bg, [torch.zeros_like(fgw), torch.zeros_like(fgm), torch.zeros_like(fgr)]
            pu, win = ns, torch.floor(win * mult)
        ns = ns + 1.0
    return {"fg": fg, "bg": bg}


def _welford_errors(got, want, center):
    """Per window: the weight difference and the max mean and raw-scatter
    errors relative to the largest entry, of the Chan-combined block
    states of ``got`` against ``want`` (``(W, mean, raw)`` per window)."""
    from littlemcmc_torch.ops.fused_nuts import combine_dense_welford

    errs = {}
    for side in ("fg", "bg"):
        Wg, Mg, Rg = combine_dense_welford(*(got[f"dense_{side}_{x}"]
                                             for x in ("w", "mean", "raw")), center)
        Ww, Mw, Rw = want[side]
        errs[f"{side}_w_diff"] = float(Wg) - float(Ww)
        errs[f"{side}_mean_rel"] = float((Mg - Mw).abs().max() / Mw.abs().max())
        errs[f"{side}_raw_rel"] = float((Rg - Rw).abs().max() / Rw.abs().max())
    return errs


def _welford_failures(errs, what):
    """Weight exact, mean within 1e-4 and raw scatter within 1e-3."""
    return [f"{side} Welford state against {what}: {errs}" for side in ("fg", "bg")
            if (errs[f"{side}_w_diff"] != 0.0 or errs[f"{side}_mean_rel"] > 1e-4
                or errs[f"{side}_raw_rel"] > 1e-3)]


def _held_stat_errors(got, want, held, da_count, config, adapting, step="nuts",
                      scaled=False):
    """The per-draw stats of the held chain-draws, kernel against plain,
    each as a share of its limit (over 1 fails). The energies of
    ``FUSED_STEPS[step]`` are within E_TOL. The accept statistic is built
    from leaf accept probabilities exp(min(0, E0 - E)), each of which moves
    by at most the error of E0 - E: within ``accept_rel`` E_TOL relative.
    The step sizes are within 1e-5 relative, plus, while dual averaging
    runs, what the accept statistic's difference moves them by:
    sqrt(count) / (gamma (count + t0)) in log step per unit of accept
    statistic.

    ``scaled`` (eight schools, the logistic regression): a draw whose
    energy moved far from the start's (|energy_error| up to 60 for eight
    schools, up to about 1400 for the logistic regression's checks, and up
    to 1e18 on a divergent leaf) ends a trajectory the step size makes
    unstable, whose rounding grows from step to step: the energies within
    E_TOL (1 + |energy_error|) (the logistic plain version in fp32 is
    within 1.1e-4 (1 + |energy change|) of a float64 run on 2l's HMC
    input, and up to 4e-3 from it unscaled); a
    tree's largest energy change, which is such a leaf's wherever it is
    large, in size within E_TOL (1 + |energy_error| + its size) where it is
    below 10 (the leaf's weight in the tree below e^-10). At 10 and above
    kernel and plain version must fall on the same side of 10 and of Emax
    (a divergent tree's exceeds Emax in both), unless the plain version's
    size lies within that limit of the threshold: ``max_energy_change_side``
    is, over the chain-draws whose sides differ, the plain version's
    distance from the threshold as a share of the limit. Its size, not its
    sign: two leaves a rounding apart in size and opposite in sign swap."""
    import torch

    kind = FUSED_STEPS[step]
    acc = kind["accept"]
    T = held.shape[0]
    size = (1.0 + want["energy_error"][:T].abs() if scaled
            else torch.ones_like(held, dtype=torch.float32))
    share = {}
    for k in kind["energies"]:
        g, w = got[k][:T], want[k][:T]
        mask, lim = held, E_TOL * size
        if scaled and k == "max_energy_change":
            g, w = g.abs(), w.abs()
            mask, lim = held & (w < 10.0), lim + E_TOL * w
            side = torch.zeros_like(lim)
            for thr in (10.0, float(config.Emax)):
                differ = held & ((g >= thr) != (w >= thr))
                side = torch.where(differ, torch.maximum(side, (w - thr).abs() / lim), side)
            share["max_energy_change_side"] = float(side.max())
        d = (g - w).abs()
        share[k] = float((d / lim)[mask].max()) if bool(mask.any()) else 0.0
    d_acc = (got[acc][:T] - want[acc][:T]).abs()
    share[acc] = float((d_acc / (kind["accept_rel"] * E_TOL * size * want[acc][:T]
                                 + 1e-7))[held].max())
    cnt = da_count[None, :] + torch.arange(T, device=da_count.device)[:, None]
    slope = (cnt.sqrt() / (float(config.gamma) * (cnt + float(config.t0)))
             if adapting else torch.zeros_like(cnt))
    for k in ("step_size", "step_size_bar"):
        rel = (got[k][:T] - want[k][:T]).abs() / want[k][:T]
        share[k] = float((rel / (1e-5 + slope * d_acc))[held].max())
    return share


def _diag_fused_inputs(model, C, seed, tuning, iter_count=300.0, swap_at=2, var_sd=None,
                       log_step=-1.2):
    """Fused-op inputs for the diag metric: positions near the posterior
    (eight schools: :func:`_es_positions`), an inverse-mass diagonal near
    the posterior variances, dual averaging part way through, and for a
    tune chunk a per-chain Welford state (40 draws in the foreground,
    10 - ``swap_at`` in the background) whose windows swap at draw
    ``swap_at`` (n_samples 50 - ``swap_at``, window 50), step sizes near 0.3 (eight schools adapts
    to about 0.27; at 0.5 the correlated Gaussian's diag trees diverge on
    96% of chain-draws; ``log_step`` their centre). ``var_sd``: the sds the
    variances are drawn near (default the posterior's; the low-rank
    metric's variances are the spiked Gaussian's squared scales). Returns the op's arguments through
    ``linv`` (None) and the Welford state (None for a draw chunk)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    dev = torch.device(DEVICE)
    n = model.ndim
    sd = _posterior_sd(model)
    q = _positions(model, rng, C)
    qt = torch.from_numpy(q).to(dev)
    logp, grad = model.batched_logp_grad(qt)

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

    ls = t(log_step + rng.uniform(-0.1, 0.1, C))
    var = t((sd if var_sd is None else var_sd) ** 2 * rng.uniform(0.5, 2.0, (C, n)))
    args = (qt, grad.contiguous(), logp.contiguous(), t(np.full(C, iter_count)), ls,
            ls.clone(), t(np.zeros(C)), t(np.full(C, 40.0)), ls + float(np.log(10.0)), var,
            None)
    if not tuning:
        return args, None
    bg_w = 10.0 - swap_at
    welford = (t(0.3 * sd * rng.standard_normal((C, n))),
               t(40.0 * sd ** 2 * rng.uniform(0.5, 2.0, (C, n))), t(np.full(C, 40.0)),
               t(np.full(C, 40.0)), t(0.3 * sd * rng.standard_normal((C, n))),
               t(bg_w * sd ** 2 * rng.uniform(0.5, 2.0, (C, n))), t(np.full(C, bg_w)),
               t(np.full(C, bg_w)), t(np.full(C, 40.0 + bg_w)), t(np.full(C, 50.0)))
    return args, welford


def _replay_diag_welford(welford, trace, mult=2.0):
    """The per-chain Welford bookkeeping in float64 over a chunk's trace,
    in ``QuadPotentialDiagAdapt.update``'s order: add to both windows, the
    foreground's variance, then the swap where ``n_samples % window ==
    0``. Returns the last draw's variance and the state by
    ``WELFORD_KEYS``."""
    import torch
    from littlemcmc_torch.ops.fused_nuts import WELFORD_KEYS

    s = {k: v.double() for k, v in zip(WELFORD_KEYS, welford)}
    var = None
    for x in trace.double():
        for side in ("fg", "bg"):
            w = s[f"{side}_w"] + 1.0
            d = x - s[f"{side}_mean"]
            m = s[f"{side}_mean"] + d / w[:, None]
            s[f"{side}_raw"] = s[f"{side}_raw"] + d * (x - m)
            s[f"{side}_mean"], s[f"{side}_w"] = m, w
            s[f"{side}_w2"] = s[f"{side}_w2"] + 1.0
        var = s["fg_raw"] / s["fg_w"][:, None]
        swap = (s["n_samples"] > 0) & (torch.remainder(s["n_samples"], s["window"]) == 0)
        for k in ("mean", "raw", "w", "w2"):
            fg, bg = s[f"fg_{k}"], s[f"bg_{k}"]
            sw = swap[:, None] if fg.ndim == 2 else swap
            s[f"fg_{k}"] = torch.where(sw, bg, fg)
            s[f"bg_{k}"] = torch.where(sw, torch.zeros_like(bg), bg)
        s["window"] = torch.where(swap, torch.floor(s["window"] * mult), s["window"])
        s["n_samples"] = s["n_samples"] + 1.0
    return var, s


def _diag_welford_errors(got, want_var, want, sd, chains=None):
    """The kernel's per-chain Welford state against ``want`` (a replay or
    the plain version) on ``chains`` (a (C,) mask, default all): the
    largest error of ``var`` in posterior variances, of the means in
    posterior sds and of the raw variances in weights times variances,
    and whether the weights and counters are equal."""
    import torch
    from littlemcmc_torch.ops.fused_nuts import WELFORD_KEYS

    sd = torch.as_tensor(sd, dtype=torch.float64, device=got["var"].device)
    rows = chains if chains is not None else torch.ones_like(got["fg_w"], dtype=torch.bool)
    errs = {"var": float(((got["var"].double() - want_var.double()).abs() / sd ** 2)[rows].max())}
    for k in WELFORD_KEYS:
        g, w = got[k].double(), want[k].double()
        if g.ndim == 2:
            scale = sd if k.endswith("mean") else want[k[:2] + "_w"].double()[:, None] * sd ** 2
            errs[k] = float(((g - w).abs() / scale)[rows].max())
        else:
            errs[k + "_equal"] = bool((g == w)[rows].all())
    return errs


def fused_check(model, C, T, tuning, adapt_step_size, seed, words, step="nuts",
                metric="dense", log_step=-1.2, dense_log_step=-0.7, chain_block=CHAIN_BLOCK,
                share=1):
    """One fused launch of ``T`` draws at ``C`` chains against the plain
    version on the same inputs (``step``: the fused NUTS op, or with
    ``"hmc"`` the fused HMC op; ``metric``: the dense branch, with the
    pooled dense adaptation in a tune chunk, the per-chain diag branch,
    with its Welford adaptation in a tune chunk, or the low-rank branch on
    the spiked Gaussian, the model's spikes as the factor, its variances
    adapted as diag's): the decisions, trace,
    energies and the per-draw stats on the chain-draws held number for
    number, and in a tune chunk the Welford state against the plain
    version and a float64 replay and the dual-averaging state against its
    update replayed over the kernel's accept statistics. NUTS's trees run
    to the sampler's depth of 10; ``log_step``: the diag and low-rank
    inputs' step sizes (:func:`_diag_fused_inputs`), ``dense_log_step``
    the dense ones' (:func:`_fused_inputs`); ``chain_block``: the chains a
    thread block; ``share``: the plain version runs on the first 1 /
    ``share`` of the chains (:func:`_plain_chains`; the inputs' chains
    reordered so that those are every ``share``-th, :func:`_spread`), and
    the kernel's launch over every chain is held against it on those, its
    Welford and dual-averaging states against their replays on every
    chain. Returns the result line, the list of failures and both outputs
    (the kernel's over every chain) and the inputs as launched."""
    import numpy as np
    import torch
    from littlemcmc_torch.base import HMCConfig, NUTSConfig
    from littlemcmc_torch.ops.fused_hmc import fused_hmc, fused_hmc_plain
    from littlemcmc_torch.ops.fused_nuts import (_da_update, combine_dense_welford,
                                                 fused_nuts, fused_nuts_plain)

    kind = FUSED_STEPS[step]
    op, plain = (fused_nuts, fused_nuts_plain) if step == "nuts" else (fused_hmc, fused_hmc_plain)
    config = (NUTSConfig(adapt_step_size=adapt_step_size) if step == "nuts"
              else HMCConfig(adapt_step_size=adapt_step_size))
    kw = dict(spec=model.trajectory_spec(), T=T, tuning=tuning, config=config, metric=metric,
              window_multiplier=2.0, chain_block=chain_block)
    if metric == "dense":
        args = _fused_inputs(model, C, seed, log_step=dense_log_step)
        welford = _welford_seed(model) if tuning else None
        kw["dense_welford"] = welford
    else:
        lowrank = metric == "lowrank"
        args, welford = _diag_fused_inputs(model, C, seed, tuning, swap_at=min(2, T - 1),
                                           var_sd=_lowrank_metric(model)[0] if lowrank else None,
                                           log_step=log_step)
        kw["welford"] = welford
        if lowrank:
            kw["fac"] = _model_fac(model, args[0].device)
    m = _plain_chains(C, share, chain_block)
    shared = (9, 10) if metric == "dense" else (10,)
    args, kw = _spread(args, kw, C, share, shared)
    if metric != "dense":
        welford = kw["welford"]
    launches = op.launches
    full = op(*args, words, **kw)
    torch.cuda.synchronize()
    pargs, pkw = _plain_inputs(args, kw, m, C, shared)
    got = _first_chains(full, m, C, T, chain_block)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want = plain(*pargs, words, **pkw)
    end.record()
    end.synchronize()

    agree = torch.stack([got[k] == want[k] for k in kind["flags"]]).all(0)  # (T, C)
    sd = torch.from_numpy(_posterior_sd(model)).float().to(got["q"].device)
    # with the step size adapting, only the first draw is held number for
    # number: dual averaging carries each draw's rounding into the next
    # draw's step size
    adapting = tuning and adapt_step_size
    checked = agree[:1] if adapting else agree
    held = _held(checked, chain_block if step == "nuts" else 1)
    Th = held.shape[0]
    dq = ((got["trace"][:Th] - want["trace"][:Th]).abs())[held]
    de = (got["energy"][:Th] - want["energy"][:Th]).abs()
    scaled = model.trajectory_spec().body in ("eight_schools", "logistic", "funnel", "auto")
    if scaled:  # the energy of a draw far from the start's, as scaled stats
        de = de / (1.0 + want["energy_error"][:Th].abs())
    de = de[held]
    work = kind["work"]
    res = {"phase": f"fused_{step}_vs_plain", "metric": metric,
           "body": model.trajectory_spec().body, "chunk": "tune" if tuning else "draw",
           "step_size_adapting": adapting, "chains": C, "plain_chains": m,
           "draws": T, "agree_share": float(checked.float().mean()),
           "agree_share_all_draws": float(agree.float().mean()),
           "held_share": float(held.float().mean()),
           f"mean_{work}": float(want[work].float().mean()),
           "divergence_share": float(want["diverging"].float().mean()),
           "q_max_abs": float(dq.max()), "q_max_err_in_sd": float(
               ((got["trace"][:Th] - want["trace"][:Th]).abs() / sd)[held].max()),
           "energy_max_abs": float(de.max()),
           "stat_tol_share": _held_stat_errors(got, want, held, pargs[7], config, adapting,
                                               step, scaled),
           "plain_ms": start.elapsed_time(end)}
    if scaled:
        # the largest |energy_error| the scaled limits widen for (draws
        # that did not diverge), and the chain-draws whose
        # max_energy_change is held by its side only
        calm = held & ~want["diverging"][:Th]
        res["max_abs_energy_error"] = float(want["energy_error"][:Th].abs()[calm].max())
        if step == "nuts":
            res["mec_over_10_share"] = float((want["max_energy_change"][:Th].abs()
                                              >= 10.0)[held].float().mean())
    if step == "nuts":
        res["mean_depth"] = float(want["depth"].float().mean())
    else:
        # the path length is the stream's call 3 times path_length: exact;
        # a step count that differs there sits on a floor boundary of
        # path / eps, eps differing in its last bits
        res["path_length_exact"] = bool((got["path_length"] == want["path_length"]).all())
        res["n_steps_boundary_draws"] = int(((got["n_steps"] != want["n_steps"])[:Th]
                                             & held).sum())
        res["accept_rate"] = float(want["accepted"].float().mean())
    failures = []
    if op.launches != launches + 1:
        failures.append(f"{op.launches - launches} kernel launches counted, not 1")
    if res["agree_share"] < 0.99 or res["held_share"] < 0.9:
        failures.append("flags agree on fewer than 99% of chain-draws, or fewer than "
                        "90% are held number for number")
    if res["q_max_err_in_sd"] > Q_TOL_SD or res["energy_max_abs"] > E_TOL:
        failures.append("q or energy differ beyond the tolerance")
    if step == "hmc" and not res["path_length_exact"]:
        failures.append("path lengths differ: the counter streams differ")
    failures += [f"stat {k} at {v:.3g} of its limit"
                 for k, v in res["stat_tol_share"].items() if v > 1.0]
    if tuning and metric == "dense":
        replay = _replay_welford(welford, full["trace"])
        res["welford_vs_replay"] = _welford_errors(full, replay, welford[0])
        failures += _welford_failures(res["welford_vs_replay"], "a float64 replay of its trace")
        if not adapting:
            plain_w = {side: combine_dense_welford(*(want[f"dense_{side}_{x}"]
                                                     for x in ("w", "mean", "raw")), welford[0])
                       for side in ("fg", "bg")}
            res["welford_vs_plain"] = _welford_errors(got, plain_w, welford[0])
            failures += _welford_failures(res["welford_vs_plain"], "the plain version")
        for k in ("n_samples", "prev_update", "window"):
            if float(got[k]) != float(want[k]):
                failures.append(f"counter {k}: {float(got[k])} vs {float(want[k])}")
    if tuning and metric in ("diag", "lowrank"):
        # the metric and the Welford rows within 1e-4 of their scales of a
        # float64 replay of the kernel's own trace (every chain), and of the
        # plain version on the chains held through the chunk; the weights
        # and counters equal
        var64, state64 = _replay_diag_welford(welford, full["trace"])
        res["welford_vs_replay"] = _diag_welford_errors(full, var64, state64, sd)
        checks = [("a float64 replay of its trace", res["welford_vs_replay"])]
        if not adapting:
            res["welford_vs_plain"] = _diag_welford_errors(got, want["var"], want, sd,
                                                           held[-1])
            checks.append(("the plain version", res["welford_vs_plain"]))
        for what, errs in checks:
            failures += [f"diag Welford {k} against {what}: {v}" for k, v in errs.items()
                         if (v is False) or (not isinstance(v, bool) and v > 1e-4)]
    if tuning and adapting:
        s = dict(zip(("da_log_step", "da_log_bar", "da_hbar", "da_count", "da_mu"),
                     args[4:9]))
        for t in range(T):
            _da_update(s, full[kind["accept"]][t], config)
        # within 1e-5 relative, 1e-6 absolute near 0 (hbar is a
        # running mean of target - accept, near 0 once adapted)
        res["da_max_abs"] = max(float((full[k] - v).abs().max()) for k, v in s.items())
        res["da_tol_share"] = max(float(((full[k] - v).abs() / (1e-6 + 1e-5 * v.abs())).max())
                                  for k, v in s.items())
        if res["da_tol_share"] > 1.0:
            failures.append("dual averaging differs from its replay")
    return res, failures, full, want, args, kw


def _compare_fused(T, tuning, adapt_step_size, seed, words, step="nuts", model=None,
                   metric="dense", chains=None, log_step=-1.2):
    """Phases 2c, 2e, 2h, 2i and 2l: :func:`fused_check` at ``chains``
    (``model``: the main path's 100-d correlated Gaussian by default),
    printed, and the kernel timed on the same input. Returns the kernel's
    and the plain version's ms, the largest q difference on the held
    chain-draws, and the kernel's work units (leaves, leapfrog steps)
    summed over chains and draws."""
    from littlemcmc_torch.models import CorrelatedGaussian
    from littlemcmc_torch.ops.fused_hmc import fused_hmc
    from littlemcmc_torch.ops.fused_nuts import fused_nuts

    op = fused_nuts if step == "nuts" else fused_hmc
    model = CorrelatedGaussian(N) if model is None else model
    res, failures, got, _, args, kw = fused_check(model, chains or CHAINS, T, tuning,
                                                  adapt_step_size, seed, words, step, metric,
                                                  log_step,
                                                  share=PLAIN_SHARE if step == "nuts" else 1)
    res["events_ms"] = _cuda_time_ms(lambda: op(*args, words, **kw), reps=5, warmup=1)
    res["kernel_ms"], res["ms_source"] = _device_ms(lambda: op(*args, words, **kw),
                                                    f"fused_{step}", 5, res["events_ms"])
    print(json.dumps(res), flush=True)
    if failures:
        raise RuntimeError(f"fused {step} kernel vs plain ({metric}, {res['body']}, "
                           f"{res['chunk']} chunk): {failures}")
    return (res["kernel_ms"], res["plain_ms"], res["q_max_abs"],
            int(got[FUSED_STEPS[step]["work"]].sum()), res["events_ms"])


def _hmc_inputs(model, chol, C, eps, seed):
    """HMC trajectory inputs at stationarity (:func:`_stationary_inputs`;
    ``chol=None``: eight schools or the logistic regression,
    :func:`_posterior_inputs`) with each chain's
    step count drawn as the sampler draws it: floor(U(0, 1) * 2 / eps), at
    least 1."""
    import numpy as np
    import torch

    q, p, grad, logp, eps_t, _, var = (_posterior_inputs(model, C, eps, seed) if chol is None
                                       else _stationary_inputs(model, chol, C, eps, seed))
    u = np.random.default_rng(seed + 1000).uniform(size=C).astype(np.float32)
    n_steps = torch.clamp((torch.from_numpy(u).to(eps_t.device) * 2.0 / eps_t).to(torch.int32),
                          1, 1024)
    return q, p, grad, logp, eps_t, n_steps, var


def hmc_check(model, args, seed, need, chain_block=512, integrator="leapfrog",
              scaled=False):
    """One launch of the HMC trajectory kernel against its plain version on
    the same inputs: the accept and divergence decisions on ``need`` of the
    chains, and on those q (within Q_TOL_SD posterior sd), the energies
    (within E_TOL) and the accept statistic (within E_TOL relative).
    ``scaled`` (eight schools, the logistic regression): a trajectory the
    step size makes unstable
    carries rounding that grows from step to step, so the energies are held
    on the chains that did not diverge, within E_TOL (1 + |energy
    change|), and the accept statistic within that relative. Returns the
    result line, the failures and both outputs."""
    import numpy as np
    import torch
    from littlemcmc_torch.ops.hmc_trajectory import hmc_trajectory, hmc_trajectory_plain

    kw = dict(spec=model.trajectory_spec(), Emax=1000.0, chain_block=chain_block,
              integrator=integrator)
    launches = hmc_trajectory.launches
    got = hmc_trajectory(*args, seed, **kw)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want = hmc_trajectory_plain(*args, seed, **kw)
    end.record()
    end.synchronize()
    agree = (got["accepted"] == want["accepted"]) & (got["diverging"] == want["diverging"])
    sd = torch.from_numpy(_posterior_sd(model)).float().to(got["q"].device)
    size = torch.ones_like(want["energy"])
    calm = agree
    if scaled:
        size = 1.0 + want["energy_change"].abs()
        calm = agree & ~want["diverging"]
    res = {"phase": "hmc_kernel_vs_plain", "body": model.trajectory_spec().body,
           "chains": args[0].shape[0], "ndim": args[0].shape[1],
           "agree_share": float(agree.float().mean()),
           "mean_n_steps": float(args[5].float().mean()),
           "max_n_steps": int(args[5].max()),
           "accept_rate": float(want["accepted"].float().mean()),
           "q_max_abs": float((got["q"] - want["q"]).abs()[agree].max()),
           "q_max_err_in_sd": float(((got["q"] - want["q"]).abs() / sd)[agree].max()),
           "plain_ms": start.elapsed_time(end)}
    for k in ("energy", "logp_end", "energy_change"):
        res[f"{k}_max_abs"] = float(((got[k] - want[k]).abs() / size)[calm].max())
    res["accept_stat_max_rel"] = float(((got["accept_stat"] - want["accept_stat"]).abs()
                                        / (size * want["accept_stat"] + 1e-7))[calm].max())
    if scaled:
        res["divergence_rate"] = float(want["diverging"].float().mean())
        res["max_abs_energy_change"] = float(want["energy_change"].abs()[calm].max())
    failures = []
    if hmc_trajectory.launches != launches + 1:
        failures.append(f"{hmc_trajectory.launches - launches} launches counted, not 1")
    if res["agree_share"] < need:
        failures.append(f"decisions agree on {res['agree_share']:.4f} of chains, need {need}")
    if res["q_max_err_in_sd"] > Q_TOL_SD:
        failures.append(f"q differs by {res['q_max_err_in_sd']} sd (limit {Q_TOL_SD})")
    if max(res[f"{k}_max_abs"] for k in ("energy", "logp_end", "energy_change")) > E_TOL:
        failures.append(f"energies differ beyond {E_TOL}")
    if res["accept_stat_max_rel"] > E_TOL:
        failures.append(f"the accept statistic differs beyond {E_TOL} relative")
    return res, failures, got, want


def _compare_hmc(model, args, seed, need, scaled=False):
    """Phases 2d and 2g: :func:`hmc_check`, printed; raises on a failure.
    Returns the largest q difference on the chains that agree and the
    plain version's ms."""
    res, failures, _, _ = hmc_check(model, args, seed, need, scaled=scaled)
    print(json.dumps(res), flush=True)
    if failures:
        raise RuntimeError(f"HMC kernel vs plain ({res['body']}): {failures}")
    return res["q_max_abs"], res["plain_ms"]


def _hmc_bound_ms(steps_total: int, C: int, n: int,
                  body: str = "correlated_gaussian", rows: int = 0) -> tuple[float, str]:
    """Least time for one HMC trajectory launch: per chain and step the
    model body and about 10n elementwise, plus 4n per chain for the two
    energies, over the steps these inputs ask for; against q, p, grad and
    the inverse mass, the scalars and the body's constants read once and
    q, grad, five scalars and two flags written once."""
    ops = steps_total * (_body_ops(body, n, rows) + 10 * n) + C * 4 * n
    consts = _body_consts(body, n, rows)
    nbytes = 4 * (4 * C * n + 3 * C + consts) + 4 * (2 * C * n + 5 * C) + 2 * C
    return _roofline_ms(ops, nbytes)


def _fused_diag_bound_ms(work_total: int, C: int, n: int, T: int, adapt_metric: bool,
                         body: str, step: str = "nuts", rows: int = 0,
                         rank: int = 0) -> tuple[float, str]:
    """Least time for one fused launch of ``T`` draws with a per-chain diag
    metric: per chain and draw about 10n for the momentum, the proposal's
    gradient (NUTS) or the two energies (HMC, 6n), and with
    ``adapt_metric`` 12n for the Welford step; per leaf (NUTS) the model
    body and about 20n elementwise, per leapfrog step (HMC) the body and
    about 10n. Bytes, each input read once and each output written once:
    q, grad and the 7 per-chain scalars (position's logp, iter_count,
    dual averaging) read and written, ``var`` and the body's constants
    read; with ``adapt_metric`` also ``var`` written and the four Welford
    rows and 6 weight and counter columns read and written; the trace and
    each draw's stats at their widths (NUTS: 7 float32, depth and leaves
    int32, 2 bool flags; HMC: 7 float32, the step count int32, 2 flags)
    written. ``rank`` > 0: the low-rank metric of that rank, its velocity
    once a leaf or step, and its momentum and the start energy's velocity
    once a draw; the factor block read once."""
    vel = _lowrank_velocity_ops(n, rank) if rank else 0
    per_work = _body_ops(body, n, rows) + (20 if step == "nuts" else 10) * n + vel
    per_draw = 10 * n + (_body_ops(body, n, rows) if step == "nuts" else 6 * n) + 2 * vel
    ops = work_total * per_work + C * T * (per_draw + (12 * n if adapt_metric else 0))
    consts = _body_consts(body, n, rows) + (_lowrank_fac_floats(n, rank) if rank else 0)
    rows_in, rows_out, cols = (5, 5, 13) if adapt_metric else (1, 0, 7)
    state = 4 * (4 * C * n + (rows_in + rows_out) * C * n + 2 * cols * C + consts)
    stat_bytes = 7 * 4 + (2 * 4 if step == "nuts" else 4) + 2 * 1
    nbytes = state + T * C * (4 * n + stat_bytes)
    return _roofline_ms(ops, nbytes)


def _fused_hmc_bound_ms(steps_total: int, C: int, n: int, T: int,
                        tuning: bool) -> tuple[float, str]:
    """Least time for one fused HMC launch of ``T`` draws: per chain and
    draw 2n^2 FLOP for the momentum, 4n^2 for the velocities of the two
    energies and, in tune, 4n^2 for the Welford adds; per step 2n^2 for
    the model body, 2n^2 for the velocity and about 10n elementwise;
    against the state, metric, L^-1 and precision read once and the trace
    and 10 stats of each draw written once."""
    ops = (steps_total * (4 * n * n + 10 * n)
           + C * T * (6 * n * n + (4 * n * n if tuning else 0)))
    nbytes = 4 * (2 * C * n + 8 * C + 3 * n * n) + 4 * (T * C * n + 10 * T * C + 2 * C * n)
    return _roofline_ms(ops, nbytes)


def _logistic_library(q, xb, y, prior_prec):
    """Row 6's function as PyTorch's library calls compute it (cuBLAS
    products in full fp32, the library softplus and sigmoid, ``addmm`` for
    the gradient): the yardstick timed as ``library_ms``, used nowhere in
    the port."""
    import torch
    import torch.nn.functional as F

    prec = float(prior_prec[0])
    logits = torch.mm(q, xb.t())
    logp = (y * logits - F.softplus(logits)).sum(1) - 0.5 * prec * (q * q).sum(1)
    return logp, torch.addmm(q, y - torch.sigmoid(logits), xb, beta=-prec)


def _quadform_library(q, prec):
    """Row 5's function as PyTorch's library calls compute it (a cuBLAS
    product in full fp32 and a row sum): the yardstick timed as
    ``library_ms``, used nowhere in the port."""
    import torch

    g = torch.mm(q, prec).neg_()
    return 0.5 * torch.einsum("ij,ij->i", q, g), g


def _device_total_ms(fn, reps: int) -> tuple[float, str]:
    """Mean device milliseconds of every kernel one call of ``fn`` runs,
    over ``reps`` calls under ``torch.profiler``; CUDA events around the
    calls (which also count the card waiting for the host) where the
    profiler sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    if total <= 0:
        return _cuda_time_ms(fn, reps, 0), "events"
    return total / reps / 1e3, "profiler"


def model_kernel_check(kind: str, C: int, n: int, rows: int = 0, seed: int = 0):
    """Row 6 (``kind="logistic"``: the design of
    ``german_credit_synthetic(rows, n - 1)`` with the intercept, positions
    from the reference posterior at the full width, else N(0, 0.3^2)) or
    row 5 (``"quadform"``: the n-d correlated Gaussian's precision, q ~
    N(0, cov)) against its plain version on the same inputs on the card,
    with ``tests/test_ops.py``'s tolerances (logistic: logp rtol 3e-4 /
    atol 1e-2, grad rtol 3e-4 / atol 1e-3; quadform: rtol 2e-4 / atol
    1e-4); the library yardstick held to the same. Returns the result
    line, the failures, and the kernel's, plain version's and library's
    calls on those inputs."""
    import numpy as np
    import torch
    from littlemcmc_torch.models import (CorrelatedGaussian, LogisticRegression,
                                         german_credit_synthetic)
    from littlemcmc_torch.ops.logistic import logistic_logp_grad, logistic_logp_grad_plain
    from littlemcmc_torch.ops.quadform import quadform_logp_grad, quadform_logp_grad_plain

    rng = np.random.default_rng(seed)
    dev = torch.device(DEVICE)
    if kind == "logistic":
        model = LogisticRegression(*german_credit_synthetic(rows, n - 1))
        q = (_positions(model, rng, C) if (rows, n) == (LG_ROWS, LG_N)
             else (0.3 * rng.standard_normal((C, n))).astype(np.float32))
        args = (torch.from_numpy(q).to(dev), model.Xb, model.y, model.prior_prec)
        op, plain, library = logistic_logp_grad, logistic_logp_grad_plain, _logistic_library
        tol = {"logp": (3e-4, 1e-2), "grad": (3e-4, 1e-3)}
    else:
        model = CorrelatedGaussian(n)
        args = (torch.from_numpy(_positions(model, rng, C)).to(dev), model.prec_f32)
        op, plain, library = quadform_logp_grad, quadform_logp_grad_plain, _quadform_library
        tol = {"logp": (2e-4, 1e-4), "grad": (2e-4, 1e-4)}
    launches = op.launches
    got = op(*args)
    torch.cuda.synchronize()
    want, lib = plain(*args), library(*args)
    res = {"phase": f"{kind}_kernel_vs_plain", "chains": C, "ndim": n, "rows": rows}
    failures = []
    if op.launches != launches + 1:
        failures.append(f"{op.launches - launches} launches counted, not 1")
    for i, k in enumerate(("logp", "grad")):
        rtol, atol = tol[k]
        for who, x in (("kernel", got[i]), ("library", lib[i])):
            d = (x - want[i]).abs()
            res[f"{who}_{k}_max_abs"] = float(d.max())
            worst = float((d - rtol * want[i].abs()).max())
            if not (worst <= atol):
                failures.append(f"{who} {k} beyond rtol {rtol} / atol {atol} ({worst})")
    calls = (lambda: op(*args), lambda: plain(*args), lambda: library(*args))
    return res, failures, calls


def _compare_model_kernel(kind: str, C: int, n: int, rows: int = 0, seed: int = 0) -> dict:
    """Phase 2j: :func:`model_kernel_check` at the main paths' widths,
    printed with the kernel's, plain version's and library's device time
    per call (:func:`_device_total_ms`, 200 calls each; the kernel's also
    on CUDA events, which count the wrapper's host work too), the plan
    the wrapper launched with and the bound; raises on a failure. Returns
    the kernel's row of the kernels line, but ``launches``."""
    from littlemcmc_torch.ops.logistic import logistic_logp_grad
    from littlemcmc_torch.ops.quadform import quadform_logp_grad

    res, failures, (kernel, plain, library) = model_kernel_check(kind, C, n, rows, seed)
    for name, fn in (("kernel", kernel), ("plain", plain), ("library", library)):
        res[f"{name}_ms"], res[f"{name}_ms_source"] = _device_total_ms(fn, 200)
    res["kernel_events_ms"] = _cuda_time_ms(kernel, reps=200, warmup=10)
    # the wrapper's host work a call, where back-to-back calls wait for it;
    # only against the profiler's device time (events hold the host work)
    res["kernel_host_ms"] = (res["kernel_events_ms"] - res["kernel_ms"]
                             if res["kernel_ms_source"] == "profiler" else None)
    op = logistic_logp_grad if kind == "logistic" else quadform_logp_grad
    res["plan"] = op.last_plan._asdict()
    bound = _logistic_bound_ms(C, n, rows) if kind == "logistic" else _quadform_bound_ms(C, n)
    res["bound_ms"], res["bound_by"] = bound
    print(json.dumps(res), flush=True)
    if failures:
        raise RuntimeError(f"{kind} kernel vs plain: {failures}")
    src, tpu = {"logistic": ("logistic_logp_grad.cu", "ops/logistic_pallas.py:66"),
                "quadform": ("quadform_logp_grad.cu", "ops/gaussian_pallas.py:53")}[kind]
    return {"name": f"{kind}_logp_grad", "route": "cuda",
            "source": f"littlemcmc_torch/ops/csrc/{src}", "replaces": f"littlemcmc_tpu/{tpu}",
            "max_abs_err": max(res["kernel_logp_max_abs"], res["kernel_grad_max_abs"]),
            "ms": res["kernel_ms"], "ms_source": res["kernel_ms_source"],
            "events_ms": res["kernel_events_ms"], "host_ms": res["kernel_host_ms"],
            "plain_ms": res["plain_ms"], "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": res["library_ms"], "chains": C, "ndim": n, "rows": rows,
            "plan": res["plan"]}


def _check_gates(label, gates) -> None:
    """Raise naming every gate of ``gates`` (``(name, passed)`` pairs)
    that failed."""
    failed = [g for g, ok in gates if not ok]
    if failed:
        raise RuntimeError(f"{label} gates failed: {failed}")


def _quality(model, trace, stats, secs, report, label, card, extra, chains=None, tune=None,
             draws=None, gated=True, per_dim=False):
    """The posterior gates of a Gaussian run (NUTS or HMC stats; by default
    the main path's chains, tune and draws); the ESS of the parameters runs
    in threads. ``per_dim``: each dimension's variance ratio in [0.9, 1.1],
    not only their mean; ``gated=False`` prints the line and checks
    nothing. Prints its JSON line."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from littlemcmc_torch.utils.diagnostics import ess_bulk

    chains = CHAINS if chains is None else chains
    tune = TUNE if tune is None else tune
    draws = DRAWS if draws is None else draws

    if trace.shape != (chains, draws, model.ndim) or not np.isfinite(trace).all():
        raise RuntimeError(f"{label}: bad trace: shape {trace.shape}, finite "
                           f"{np.isfinite(trace).all()}")
    t_ess = time.perf_counter()
    flat = trace.reshape(-1, model.ndim)
    sd = np.sqrt(model.true_var)
    ratios = flat.var(0) / model.true_var
    var_ratio = float(ratios.mean())
    mean_err = float((np.abs(flat.mean(0)) / sd).max())
    div_rate = float(stats["diverging"].mean())
    with ThreadPoolExecutor(8) as pool:
        min_ess = float(min(pool.map(lambda i: ess_bulk(trace[:, :, i]), range(model.ndim))))
    line = {"phase": label, "engine": report["engine"],
            "trajectory": report["trajectory"], "chain_block": report["chain_block"],
            "chains": chains, "ndim": model.ndim, "tune": tune, "draws": draws, **extra,
            "sample_seconds": secs,
            "transitions_per_s": chains * (tune + draws) / secs,
            "min_bulk_ess": min_ess, "min_bulk_ess_per_s": min_ess / secs,
            "divergence_rate": div_rate, "posterior_var_ratio": var_ratio,
            "posterior_var_ratio_min": float(ratios.min()),
            "posterior_var_ratio_max": float(ratios.max()),
            "max_abs_mean_over_sd": mean_err,
            "step_size": float(stats["step_size"][:, -1].mean()),
            "ess_seconds": time.perf_counter() - t_ess, "card": card}
    if "tree_size" in stats:
        line.update(mean_tree_size=float(stats["tree_size"].mean()),
                    mean_depth=float(stats["depth"].mean()),
                    mean_tree_accept=float(stats["mean_tree_accept"].mean()))
    else:
        line.update(mean_n_steps=float(stats["n_steps"].mean()),
                    accept=float(stats["accept"].mean()),
                    accepted=float(stats["accepted"].mean()))
    print(json.dumps(line), flush=True)
    gates = [("divergence_rate < 0.01", div_rate < 0.01),
             ("0.9 <= posterior_var_ratio <= 1.1", 0.9 <= var_ratio <= 1.1),
             ("max |mean| / sd < 0.1", mean_err < 0.1),
             ("min bulk ESS > 1000", min_ess > 1000)]
    if per_dim:
        gates.append(("each dimension's var ratio in [0.9, 1.1]",
                      bool(((ratios >= 0.9) & (ratios <= 1.1)).all())))
    if gated:
        _check_gates(label, gates)
    return line


def _es_quality(model, exact, trace, stats, report, label, card, div_limit, extra):
    """The gates of an eight-schools run: divergence rate below
    ``div_limit``, max split R-hat < 1.05 and min bulk ESS > 1000 over the
    ten parameters, and the posterior mean of mu and log_tau within 0.1
    posterior sd of the exact values (``exact``, from
    ``EightSchools.exact_moments``), their sds within 10%. The diagnostics
    of the ten parameters run in threads. Prints its JSON line."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from littlemcmc_torch.utils.diagnostics import ess_bulk, split_rhat

    shape = (ES_CHAINS, ES_DRAWS, model.ndim)
    if trace.shape != shape or not np.isfinite(trace).all():
        raise RuntimeError(f"{label}: bad trace: shape {trace.shape}, finite "
                           f"{np.isfinite(trace).all()}")
    t_ess = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        ess = list(pool.map(lambda i: ess_bulk(trace[:, :, i]), range(model.ndim)))
        rhat = list(pool.map(lambda i: split_rhat(trace[:, :, i]), range(model.ndim)))
    secs = report["sample_seconds"]
    div_rate = float(stats["diverging"].mean())
    line = {"phase": label, "engine": report["engine"], "trajectory": report["trajectory"],
            "chains": ES_CHAINS, "ndim": model.ndim, "tune": ES_TUNE, "draws": ES_DRAWS,
            "target_accept": ES_TARGET, **extra, "sample_seconds": secs,
            "transitions_per_s": ES_CHAINS * (ES_TUNE + ES_DRAWS) / secs,
            "min_bulk_ess": float(min(ess)), "min_bulk_ess_per_s": float(min(ess)) / secs,
            "max_split_rhat": float(max(rhat)), "divergence_rate": div_rate,
            "step_size": float(stats["step_size"][:, -1].mean()),
            "ess_seconds": time.perf_counter() - t_ess, "card": card}
    gates = [(f"divergence_rate < {div_limit}", div_rate < div_limit),
             ("max split R-hat < 1.05", line["max_split_rhat"] < 1.05),
             ("min bulk ESS > 1000", line["min_bulk_ess"] > 1000)]
    for i, name in enumerate(("mu", "log_tau")):
        mean, sd = exact[name]
        x = trace[:, :, i].astype(np.float64)
        line[f"{name}_mean"], line[f"{name}_sd"] = float(x.mean()), float(x.std())
        line[f"{name}_mean_err_in_sd"] = abs(line[f"{name}_mean"] - mean) / sd
        line[f"{name}_sd_ratio"] = line[f"{name}_sd"] / sd
        gates += [(f"|{name} mean - {mean:.3f}| < 0.1 sd", line[f"{name}_mean_err_in_sd"] < 0.1),
                  (f"{name} sd within 10% of {sd:.3f}", abs(line[f"{name}_sd_ratio"] - 1) < 0.1)]
    if "tree_size" in stats:
        line.update(mean_tree_size=float(stats["tree_size"].mean()),
                    mean_depth=float(stats["depth"].mean()),
                    mean_tree_accept=float(stats["mean_tree_accept"].mean()))
    else:
        line.update(mean_n_steps=float(stats["n_steps"].mean()),
                    accept=float(stats["accept"].mean()))
    print(json.dumps(line), flush=True)
    _check_gates(label, gates)
    return line


def _logistic_quality(trace, stats, report, label, card, extra, tune=None, draws=None,
                      ref=None):
    """The gates of a logistic run (BASELINE config 4), or with ``ref`` of
    another model against its reference moments: divergence rate below 1%,
    max split R-hat < 1.01 and min bulk ESS > 1000 over the parameters,
    each posterior mean within 0.1 reference sd of the reference mean and
    each sd within 10% of the reference sd. The diagnostics run in
    threads. Prints and returns its JSON line."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from littlemcmc_torch.utils.diagnostics import ess_bulk, split_rhat

    tune = LG_TUNE if tune is None else tune
    draws = LG_DRAWS if draws is None else draws
    ref = _reference() if ref is None else ref
    ndim = len(ref["mean"])
    if trace.shape != (CHAINS, draws, ndim) or not np.isfinite(trace).all():
        raise RuntimeError(f"{label}: bad trace: shape {trace.shape}, finite "
                           f"{np.isfinite(trace).all()}")
    t_ess = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        ess = list(pool.map(lambda i: ess_bulk(trace[:, :, i]), range(ndim)))
        rhat = list(pool.map(lambda i: split_rhat(trace[:, :, i]), range(ndim)))
    flat = trace.reshape(-1, ndim).astype(np.float64)
    mean_err = np.abs(flat.mean(0) - np.array(ref["mean"])) / np.array(ref["sd"])
    sd_ratio = flat.std(0) / np.array(ref["sd"])
    secs = report["sample_seconds"]
    line = {"phase": label, "engine": report["engine"], "trajectory": report["trajectory"],
            "chains": CHAINS, "ndim": ndim, "tune": tune, "draws": draws, **extra,
            "sample_seconds": secs, "ms_per_draw": 1e3 * secs / (tune + draws),
            "transitions_per_s": CHAINS * (tune + draws) / secs,
            "min_bulk_ess": float(min(ess)), "min_bulk_ess_per_s": float(min(ess)) / secs,
            "max_split_rhat": float(max(rhat)),
            "divergence_rate": float(stats["diverging"].mean()),
            "max_mean_err_in_ref_sd": float(mean_err.max()),
            "max_sd_ratio_err": float(np.abs(sd_ratio - 1).max()),
            "step_size": float(stats["step_size"][:, -1].mean()),
            "mean_tree_size": float(stats["tree_size"].mean()),
            "mean_depth": float(stats["depth"].mean()),
            "max_depth": int(stats["depth"].max()),
            "mean_tree_accept": float(stats["mean_tree_accept"].mean()),
            "ess_seconds": time.perf_counter() - t_ess, "card": card}
    print(json.dumps(line), flush=True)
    _check_gates(label, [("divergence_rate < 0.01", line["divergence_rate"] < 0.01),
                         ("max split R-hat < 1.01", line["max_split_rhat"] < 1.01),
                         ("min bulk ESS > 1000", line["min_bulk_ess"] > 1000),
                         ("each mean within 0.1 reference sd", line["max_mean_err_in_ref_sd"] < 0.1),
                         ("each sd within 10% of the reference", line["max_sd_ratio_err"] < 0.1)])
    line["posterior_mean"] = flat.mean(0)
    return line


def _breakdown(model, state, gen, draws: int = 50, step: str = "nuts", label: str = "",
               tree_fn=None, pooled: bool = False) -> dict:
    """Where a post-tune draw's time goes: ``draws`` transitions from a
    main path's final state (``step``: the NUTS or the HMC path; with
    ``tree_fn``, NUTS on the tensor-op tree calling that batched model,
    the logistic kernel) under ``torch.profiler``; device time by kernel
    over the window's time on CUDA events. ``label`` is appended to the
    phase's name; ``pooled``: the state's metric is pooled across chains
    (the low-rank one). Prints and returns its line."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from littlemcmc_torch.base import HMCConfig, NUTSConfig
    from littlemcmc_torch.hmc import build_hmc_kernel
    from littlemcmc_torch.nuts import build_nuts_kernel

    if tree_fn is not None:
        kernel = build_nuts_kernel(NUTSConfig(), None, batched_logp_grad_fn=tree_fn)
        name = "logistic_logp_grad"
    elif step == "nuts":
        kernel = build_nuts_kernel(NUTSConfig(), model.trajectory_spec(), pooled_metric=pooled)
        name = "nuts_trajectory"
    else:
        kernel = build_hmc_kernel(model.batched_logp_grad, HMCConfig(), model.trajectory_spec())
        name = "hmc_trajectory"
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
    traj = sum(t for k, t in by_kernel.items() if name in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:4]
    line = {
        "phase": ("breakdown" if step == "nuts" else "hmc_breakdown") + label, "draws": draws,
        "ms_per_draw": window_us / draws / 1e3,
        "device_busy_share": busy / window_us if busy else "not measured",
        "trajectory_kernel_share": traj / window_us if busy else "not measured",
        "trajectory_kernel_ms_per_draw": traj / draws / 1e3 if busy else "not measured",
        "other_kernels": len(by_kernel) - 1,
        "top_device_us": [[k[:60], t] for k, t in top]}
    if tree_fn is not None:
        line["kernel"] = name
        line["kernel_launches_per_draw"] = sum(
            e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key) / draws
        line["device_kernels_per_draw"] = sum(
            e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA) / draws
    print(json.dumps(line), flush=True)
    return line


def _fused_breakdown(model, state, chunk: int, iter0: int) -> None:
    """Where one draw chunk of the fused engine spends its time: the
    runner's chunk (L^-1, the launch, the state) from 3b's final state
    under ``torch.profiler``, device time by kernel over the chunk's time
    on CUDA events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from littlemcmc_torch.base import NUTSConfig
    from littlemcmc_torch.nuts import build_fused_nuts_runner_factory

    factory = build_fused_nuts_runner_factory(NUTSConfig(), model.trajectory_spec(),
                                              state.potential, True, (101, 103))
    run = factory(chunk, False, True)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        run(state, iter0)
        end.record()
        end.synchronize()
    window_us = 1e3 * start.elapsed_time(end)
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            by_kernel[e.key] = e.self_device_time_total
    busy = sum(by_kernel.values())
    fused = sum(t for k, t in by_kernel.items() if "fused_nuts" in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:4]
    print(json.dumps({
        "phase": "fused_breakdown", "draws": chunk, "chunk_ms": window_us / 1e3,
        "ms_per_draw": window_us / chunk / 1e3,
        "device_busy_share": busy / window_us if busy else "not measured",
        "fused_kernel_share": fused / window_us if busy else "not measured",
        "other_kernels": len(by_kernel) - (1 if fused else 0),
        "top_device_us": [[k[:60], t] for k, t in top]}), flush=True)


def _fused_path_breakdown(model, step: str = "nuts", sample_kw=None, draw_chunks: int = 4,
                          label: str = "") -> dict:
    """Where a fused call spends its time: the call once more under
    ``torch.profiler`` (by default the 3b call, with ``step="hmc"`` the 3e
    call; ``sample_kw`` replaces its arguments); the fused kernel's device
    time launch by launch (the tune chunks, then ``draw_chunks`` draw
    chunks), and over the window from the first launch's start to the last
    one's end, the other kernels' device time (the metric updates between
    chunks) and the device's busy share. Prints and returns its line."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from littlemcmc_torch import HamiltonianMC, sample

    report = {}
    name = "fused_nuts" if step == "nuts" else "fused_hmc"
    if sample_kw is None:
        sample_kw = dict(model_ndim=N, chains=CHAINS, tune=TUNE, draws=DRAWS, init="adapt_full",
                         step=HamiltonianMC(model_ndim=N) if step == "hmc" else None)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sample(model.logp_grad, random_seed=42, perf_report=report, progressbar=False,
               compute_convergence_checks=False, **sample_kw)
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    fused = [e for e in kernels if name in e.name]
    line = {"phase": f"{name}_path_breakdown{label}", "engine": report["engine"],
            "sample_seconds_profiled": report["sample_seconds"]}
    if not fused:
        line["fused_launch_ms"] = "not measured"
    else:
        t0, t1 = fused[0].time_range.start, fused[-1].time_range.end
        fused_us = [e.time_range.elapsed_us() for e in fused]
        other_us = sum(e.time_range.elapsed_us() for e in kernels
                       if name not in e.name and t0 <= e.time_range.start
                       and e.time_range.end <= t1)
        line.update(fused_launch_ms=[t / 1e3 for t in fused_us],
                    fused_tune_ms=sum(fused_us[:-draw_chunks]) / 1e3,
                    fused_draw_ms=sum(fused_us[-draw_chunks:]) / 1e3,
                    window_ms=(t1 - t0) / 1e3, other_kernels_in_window_ms=other_us / 1e3,
                    device_busy_share=(sum(fused_us) + other_us) / (t1 - t0),
                    fused_share_of_sample=sum(fused_us) / 1e6 / report["sample_seconds"])
    print(json.dumps(line), flush=True)
    return line


def _es_kernel_timing(model, state, pd_state, step: str, gen, label: str = "es") -> dict:
    """The eight-schools kernels' time at the main paths' final states
    (10,240 chains): the fused kernel's kDiag instance per 250-draw draw
    chunk at the fused path's (device time under the profiler) with its
    bound, and the per-draw kernel with the eight-schools body per launch
    at the twin's (``pd_state``), with fresh momenta and the sampler's step
    counts, with its bound."""
    import torch
    from littlemcmc_torch.base import HMCConfig, NUTSConfig
    from littlemcmc_torch.ops.fused_hmc import fused_hmc
    from littlemcmc_torch.ops.fused_nuts import fused_nuts
    from littlemcmc_torch.ops.hmc_trajectory import hmc_trajectory
    from littlemcmc_torch.ops.nuts_trajectory import trajectory

    C, n = state.q.shape
    spec = model.trajectory_spec()
    pot, da = state.potential, state.da
    cfg = (NUTSConfig if step == "nuts" else HMCConfig)(target_accept=ES_TARGET)
    op = fused_nuts if step == "nuts" else fused_hmc
    fargs = (state.q, state.q_grad, state.logp, state.iter_count.float(), da.log_step,
             da.log_bar, da.hbar, da.count.float(), da.mu, pot.var.contiguous(), None)
    fkw = dict(spec=spec, T=250, tuning=False, config=cfg, metric="diag",
               chain_block=CHAIN_BLOCK)
    out = op(*fargs, (5, 9), **fkw)
    work = int(out["n_leaves" if step == "nuts" else "n_steps"].sum())
    events = _cuda_time_ms(lambda: op(*fargs, (5, 9), **fkw), reps=3, warmup=0)
    f_ms, f_src = _device_ms(lambda: op(*fargs, (5, 9), **fkw), f"fused_{step}", 3, events)
    f_bound, f_by = _fused_diag_bound_ms(work, C, n, 250, False, spec.body, step)
    s, var = pd_state, pd_state.potential.var.contiguous()
    eps = torch.exp(s.da.log_bar)
    p0 = s.potential.sample_momentum(gen)
    if step == "nuts":
        pname = "nuts_trajectory"
        # a fused engine's state holds its scalars as strided views
        targs = (s.q.contiguous(), p0, s.q_grad.contiguous(), s.logp.contiguous(), eps,
                 torch.full((C,), DEPTH, dtype=torch.int32, device=DEVICE), var)
        kw = dict(spec=spec, max_treedepth=DEPTH, Emax=1000.0, chain_block=CHAIN_BLOCK)
        pout = trajectory(*targs, (3, 8), **kw)
        p_bound, p_by = _bound_ms(int(pout["n_leaves"].sum()), C, n, body=spec.body)

        def call():
            return trajectory(*targs, (3, 8), **kw)
    else:
        pname = "hmc_trajectory"
        path = torch.rand(C, generator=gen, device=DEVICE) * cfg.path_length
        nst = torch.clamp((path / eps).to(torch.int32), 1, cfg.max_steps)
        targs = (s.q, p0, s.q_grad, s.logp, eps, nst, var)
        kw = dict(spec=spec, Emax=1000.0)
        p_bound, p_by = _hmc_bound_ms(int(nst.sum()), C, n, body=spec.body)

        def call():
            return hmc_trajectory(*targs, (3, 8), **kw)
    p_events = _cuda_time_ms(call, reps=20, warmup=3)
    p_ms, p_src = _device_ms(call, pname, 20, p_events)
    line = {"phase": f"{label}_{step}_kernel_timing", "chains": C,
            "fused_chunk_draws": 250, "fused_ms": f_ms, "fused_ms_source": f_src,
            "fused_events_ms": events, "fused_bound_ms": f_bound, "fused_bound_by": f_by,
            "fused_work_per_chain_draw": work / C / 250,
            "per_draw_ms": p_ms, "per_draw_ms_source": p_src, "per_draw_events_ms": p_events,
            "per_draw_bound_ms": p_bound, "per_draw_bound_by": p_by}
    from littlemcmc_torch.ops._build import last_blocks_per_sm

    # the blocks an SM of the fused launch (and of NUTS's per-draw launch)
    # just timed
    line["fused_blocks_per_sm"] = last_blocks_per_sm(f"fused_{step}")
    if step == "nuts":
        line["per_draw_blocks_per_sm"] = last_blocks_per_sm("nuts_trajectory")
    print(json.dumps(line), flush=True)
    return line


def _tree_paths(smi, lg, reset_counts, counts, model_ops, t_start) -> dict:
    """Phases 3l-3n (``lg``: the default ``LogisticRegression``;
    ``reset_counts``, ``counts`` and ``model_ops``: ``main``'s launch
    counters). Raises on a failed check or gate; returns each path's final
    state, gate line and launch count."""
    import numpy as np
    from littlemcmc_torch import NUTS, sample
    from littlemcmc_torch.models import CorrelatedGaussian, LogisticRegression
    from littlemcmc_torch.ops.logistic import logistic_logp_grad
    from littlemcmc_torch.ops.nuts_trajectory import trajectory
    from littlemcmc_torch.ops.quadform import quadform_logp_grad

    # 3l. path (A): logistic regression on the tensor-op tree, every leaf
    # one launch of the batched logistic kernel
    reset_counts()
    lg_k = LogisticRegression(use_kernel=True)
    report_a = {}
    trace_a, stats_a, state_a = sample(
        lg_k.logp_grad, model_ndim=LG_N, chains=CHAINS, tune=LG_TREE_TUNE, draws=LG_TREE_DRAWS,
        random_seed=42, step=NUTS(model_ndim=LG_N, batched_logp_dlogp_func=lg_k.batched_logp_grad,
                                  trajectory_spec=None),
        perf_report=report_a, return_final_state=True, progressbar=False,
        compute_convergence_checks=False)
    a_launches = logistic_logp_grad.launches
    if (report_a["engine"] != "per_draw_diag" or report_a["trajectory"] != "tensor"
            or any(counts().values()) or a_launches <= 0 or quadform_logp_grad.launches):
        raise RuntimeError(f"logistic on the tree ran engine {report_a['engine']} "
                           f"({report_a['trajectory']}) with launches {counts()}, "
                           f"{a_launches} of the logistic kernel")
    line_a = _logistic_quality(trace_a, stats_a, report_a, "logistic_tree", smi,
                               {"kernel_launches": {"logistic_logp_grad": a_launches}},
                               tune=LG_TREE_TUNE, draws=LG_TREE_DRAWS)

    # 3m. path (B): the default call, the trajectory kernel's logistic body
    reset_counts()
    report_b = {}
    trace_b, stats_b, state_b = sample(lg.logp_grad, model_ndim=LG_N, chains=CHAINS,
                                       tune=LG_TUNE, draws=LG_DRAWS, random_seed=42,
                                       perf_report=report_b, return_final_state=True,
                                       progressbar=False, compute_convergence_checks=False)
    b_launches = trajectory.launches
    want = {"trajectory": LG_TUNE + LG_DRAWS, "fused_nuts": 0, "hmc_trajectory": 0,
            "fused_hmc": 0}
    if (report_b["engine"] != "per_draw_diag" or counts() != want
            or any(op.launches for op in model_ops)):
        raise RuntimeError(f"the default logistic call ran engine {report_b['engine']} with "
                           f"launches {counts()}, expected per_draw_diag and {want}")
    line_b = _logistic_quality(trace_b, stats_b, report_b, "logistic_default", smi,
                               {"kernel_launches": report_b["kernel_launches"]})
    engines_diff = float((np.abs(line_a["posterior_mean"] - line_b["posterior_mean"])
                          / np.array(_reference()["sd"])).max())
    _line(phase="logistic_engines", tree_sample_seconds=line_a["sample_seconds"],
          kernel_sample_seconds=line_b["sample_seconds"],
          max_mean_diff_in_ref_sd=f"{engines_diff:.4f}",
          elapsed_s=f"{time.perf_counter() - t_start:.1f}")
    _check_gates("logistic_engines",
                 [("the engines' means within 0.1 reference sd", engines_diff < 0.1)])

    # 3n. T2: per-chain dense adaptation on the tree, the quadform kernel at
    # every leaf
    reset_counts()
    cg_k = CorrelatedGaussian(N, use_kernel=True)
    report_t = {}
    trace_t, stats_t = sample(cg_k.logp_grad, model_ndim=N, chains=T2_CHAINS, tune=T2_TUNE,
                              draws=T2_DRAWS, random_seed=42, init="jitter+adapt_full",
                              cross_chain_adapt=False, max_treedepth=T2_DEPTH,
                              perf_report=report_t, progressbar=False,
                              compute_convergence_checks=False)
    t2_launches = quadform_logp_grad.launches
    if (report_t["engine"] != "per_draw_dense" or report_t["trajectory"] != "tensor"
            or any(counts().values()) or t2_launches <= 0 or logistic_logp_grad.launches):
        raise RuntimeError(f"T2 ran engine {report_t['engine']} ({report_t['trajectory']}) "
                           f"with launches {counts()}, {t2_launches} of the quadform kernel")
    line_t = _quality(cg_k, trace_t, stats_t, report_t["sample_seconds"], report_t,
                      "t2_per_chain_dense_tree", smi,
                      {"kernel_launches": {"quadform_logp_grad": t2_launches},
                       "max_depth": int(stats_t["depth"].max())},
                      chains=T2_CHAINS, tune=T2_TUNE, draws=T2_DRAWS)
    _line(phase="tree_paths_done", t2_sample_seconds=line_t["sample_seconds"],
          elapsed_s=f"{time.perf_counter() - t_start:.1f}")
    return dict(lg_k=lg_k, state_a=state_a, state_b=state_b, a_launches=a_launches,
                b_launches=b_launches, t2_launches=t2_launches)


def _logistic_timing(lg, tp, lg_args, lg_hargs, gen, t_start) -> dict:
    """Phase 4f: where a draw of paths (A) and (B) spends its time, the
    trajectory kernel's logistic body at 2k's input (``lg_args``, where its
    plain version was timed) and at path (B)'s final state (``tp``:
    :func:`_tree_paths`' result), and the HMC kernel's at 2l's input
    (``lg_hargs``). Returns the times and bounds of the kernels line."""
    import torch
    from littlemcmc_torch.ops.hmc_trajectory import hmc_trajectory
    from littlemcmc_torch.ops.nuts_trajectory import trajectory

    lg_k, state_a, state_b = tp["lg_k"], tp["state_a"], tp["state_b"]
    _breakdown(lg_k, state_a, gen, draws=5, label="_logistic_tree",
               tree_fn=lg_k.batched_logp_grad)
    _breakdown(lg, state_b, gen, label="_logistic")
    lkw = dict(spec=lg.trajectory_spec(), max_treedepth=DEPTH, Emax=1000.0,
               chain_block=CHAIN_BLOCK)
    largs = (state_b.q, state_b.potential.sample_momentum(gen), state_b.q_grad, state_b.logp,
             torch.exp(state_b.da.log_bar),
             torch.full((CHAINS,), DEPTH, dtype=torch.int32, device=DEVICE),
             state_b.potential.var)
    out = {}
    for where, args, seed in (("", lg_args, (109, -113)), ("main_", largs, (3, 8))):
        leaves = int(trajectory(*args, seed, **lkw)["n_leaves"].sum())
        events = _cuda_time_ms(lambda: trajectory(*args, seed, **lkw), reps=20, warmup=3)
        ms, src = _device_ms(lambda: trajectory(*args, seed, **lkw), "nuts_trajectory", 20,
                             events)
        bound = _bound_ms(leaves, CHAINS, LG_N, body="logistic", rows=LG_ROWS)
        out.update({f"{where}ms": ms, f"{where}ms_source": src, f"{where}events_ms": events,
                    f"{where}bound_ms": bound[0], f"{where}bound_by": bound[1]})
        _line(phase=f"logistic_{where}timing", kernel_ms=f"{ms:.4f}", ms_source=src,
              events_ms=f"{events:.4f}", bound_ms=f"{bound[0]:.4f}", bound_by=bound[1],
              mean_leaves=f"{leaves / CHAINS:.2f}",
              elapsed_s=f"{time.perf_counter() - t_start:.1f}")
    lhkw = dict(spec=lg.trajectory_spec(), Emax=1000.0)
    lh_events = _cuda_time_ms(lambda: hmc_trajectory(*lg_hargs, (131, 137), **lhkw), reps=20,
                              warmup=3)
    lh_ms, lh_src = _device_ms(lambda: hmc_trajectory(*lg_hargs, (131, 137), **lhkw),
                               "hmc_trajectory", 20, lh_events)
    lh_bound = _hmc_bound_ms(int(lg_hargs[5].sum()), 256, LG_N, body="logistic", rows=LG_ROWS)
    return dict(lg_row=out, lh_ms=lh_ms, lh_src=lh_src, lh_events=lh_events,
                lh_bound=lh_bound)


def _lowrank_cells(smi, sg, reset_counts, counts, t_start) -> dict:
    """Phases 3o-3r: ``sample(SpikedGaussian(100).logp_grad, model_ndim=100,
    init="jitter+adapt_lowrank", chains=1024, tune=500, draws=1000,
    random_seed=42)`` (L1: pooled, ``fused_lowrank_pooled`` on the fused
    NUTS kernel, 12 launches: tune chunks of 10, 10, 30, 50 and 4 x 100
    draws, then 4 x 250), the same with ``fuse_draws=False`` (L2:
    ``per_draw_lowrank_pooled``, 1500 launches of the trajectory kernel's
    low-rank branch) and with ``HamiltonianMC`` (L3: ``fused_lowrank_pooled``
    on the fused HMC kernel), each under the main path's gates with each
    dimension's variance ratio in [0.9, 1.1]; and L0, the diag contrast
    (``init="jitter+adapt_diag"``: ``per_draw_diag`` on body 4), ungated.
    The learned-metric gate: L1's min bulk ESS per 1000 leapfrogs at least
    10x L0's. Returns ``{label: (line, final state)}``."""
    import numpy as np
    from littlemcmc_torch import HamiltonianMC, sample

    from littlemcmc_torch.base import pooled_tune_schedule

    # the fused engine's launches: tune chunks to the pooled schedule's
    # boundaries (10, 20, 50, 100, then every 100), then 250-draw chunks
    t, chunks = 0, 0
    while t < TUNE:
        t, chunks = min(TUNE, t + min(250, pooled_tune_schedule(t))), chunks + 1
    chunks += -(-DRAWS // 250)
    cells = (("L1", {}, "fused_lowrank_pooled", {"fused_nuts": chunks}),
             ("L2", dict(fuse_draws=False), "per_draw_lowrank_pooled",
              {"trajectory": TUNE + DRAWS}),
             ("L3", dict(step=HamiltonianMC(model_ndim=N)), "fused_lowrank_pooled",
              {"fused_hmc": chunks}),
             ("L0", dict(init="jitter+adapt_diag"), "per_draw_diag",
              {"trajectory": TUNE + DRAWS}))
    out = {}
    for label, kw, engine, want in cells:
        reset_counts()
        rep = {}
        kw = dict(dict(init="jitter+adapt_lowrank"), **kw)
        tr, st, fs = sample(sg.logp_grad, model_ndim=N, chains=CHAINS, tune=TUNE, draws=DRAWS,
                            random_seed=42, perf_report=rep, return_final_state=True,
                            progressbar=False, **kw)
        got = {k: v for k, v in counts().items() if v}
        if rep["engine"] != engine or got != want:
            raise RuntimeError(f"low-rank cell {label}: engine {rep['engine']}, launches "
                               f"{got}; expected {engine}, {want}")
        probes = _probe_launches(fused=engine.startswith("fused"), lowrank=label != "L0")
        leapfrogs = float(np.sum(st["tree_size"] if "tree_size" in st else st["n_steps"]))
        line = _quality(sg, tr, st, rep["sample_seconds"], rep, f"lowrank_{label}", smi,
                        {"kernel_launches": got, "probe_launches": probes,
                         "draw_leapfrogs": leapfrogs},
                        gated=label != "L0", per_dim=True)
        line["min_bulk_ess_per_1000_leapfrogs"] = 1e3 * line["min_bulk_ess"] / leapfrogs
        out[label] = (line, fs)
    per_klf = {k: v[0]["min_bulk_ess_per_1000_leapfrogs"] for k, v in out.items()}
    _line(phase="lowrank_cells", **{f"{k}_sample_seconds": v[0]["sample_seconds"]
                                    for k, v in out.items()},
          **{f"{k}_min_bulk_ess_per_1000_leapfrogs": v for k, v in per_klf.items()},
          L1_over_L0=per_klf["L1"] / per_klf["L0"],
          elapsed_s=f"{time.perf_counter() - t_start:.1f}")
    _check_gates("lowrank", [("L1 min bulk ESS per 1000 leapfrogs >= 10x L0's",
                              per_klf["L1"] >= 10.0 * per_klf["L0"])])
    return out


def _lowrank_timing(sg, lr, lr_args, lr_cmp, sg_args, sg_cmp, sg_hargs, sg_hmc_cmp, lr_fused,
                    gen, t_start) -> list:
    """Phase 4g: the low-rank kernels and the spiked body, and their rows
    of the kernels line. The trajectory kernel's low-rank branch at L2's
    final state (``ms``; ``check_ms``, ``plain_ms`` and ``max_abs_err`` at
    2m's input, the same shapes); body 4 at kDiag at 2m's input (256
    chains; ``main_ms`` at L0's final state, 1024 chains); body 4 in the
    HMC kernel at 2m's input (on no cell's path); the fused kernels'
    low-rank branch at 2n's draw-chunk input (2 draws of 256 chains;
    ``chunk_*``: one 250-draw launch at L1's or L3's final state). Then
    where L1's call and a post-tune draw of L2 spend their time."""
    import torch
    from littlemcmc_torch import HamiltonianMC
    from littlemcmc_torch.base import HMCConfig, NUTSConfig
    from littlemcmc_torch.nuts import _shared_lowrank_factor
    from littlemcmc_torch.ops._build import last_blocks_per_sm
    from littlemcmc_torch.ops.fused_hmc import fused_hmc
    from littlemcmc_torch.ops.fused_nuts import fused_nuts
    from littlemcmc_torch.ops.hmc_trajectory import hmc_trajectory
    from littlemcmc_torch.ops.nuts_trajectory import trajectory

    spec, k = sg.trajectory_spec(), sg.rank
    kw = dict(spec=spec, max_treedepth=DEPTH, Emax=1000.0, chain_block=CHAIN_BLOCK)
    traj_src = "littlemcmc_torch/ops/csrc/nuts_trajectory.cu"
    traj_tpu = "littlemcmc_tpu/ops/nuts_trajectory_pallas.py:1023"

    def state_args(state, metric):
        pot = state.potential
        var = pot.stds.contiguous() if metric == "lowrank" else pot.var
        return (state.q, pot.sample_momentum(gen), state.q_grad, state.logp,
                torch.exp(state.da.log_bar),
                torch.full((CHAINS,), DEPTH, dtype=torch.int32, device=DEVICE), var)

    def traj_time(args, metric, fac=None, reps=20):
        mkw = dict(kw, metric=metric, fac=fac)
        leaves = int(trajectory(*args, (3, 8), **mkw)["n_leaves"].sum())
        ev = _cuda_time_ms(lambda: trajectory(*args, (3, 8), **mkw), reps=reps, warmup=2)
        ms, src = _device_ms(lambda: trajectory(*args, (3, 8), **mkw), "nuts_trajectory",
                             reps, ev)
        return ms, src, ev, leaves

    rows = []
    # the trajectory kernel's low-rank branch
    l2_line, l2_state = lr["L2"]
    l2_fac = _shared_lowrank_factor(l2_state.potential, True)
    ms, src, ev, leaves = traj_time(state_args(l2_state, "lowrank"), "lowrank", l2_fac)
    c_ms, c_src, _, c_leaves = traj_time(lr_args[0], "lowrank", lr_args[1])
    # the bound counts the factor's own rank: L2's learned one, 2m's the
    # model's spikes
    bound = _bound_ms(leaves, CHAINS, N, "lowrank", "spiked_gaussian", k,
                      _fac_rank(l2_fac, N))
    c_bound = _bound_ms(c_leaves, CHAINS, N, "lowrank", "spiked_gaussian", k,
                        _fac_rank(lr_args[1], N))
    rows.append({"name": "nuts_trajectory", "metric": "lowrank", "body": "spiked_gaussian",
                 "route": "cuda", "source": traj_src, "replaces": traj_tpu,
                 "launches": l2_line["kernel_launches"]["trajectory"],
                 "max_abs_err": lr_cmp[0], "ms": ms, "ms_source": src, "events_ms": ev,
                 "plain_ms": lr_cmp[1], "bound_ms": bound[0], "bound_by": bound[1],
                 "library_ms": None, "mean_leaves": leaves / CHAINS,
                 "fac_rank": _fac_rank(l2_fac, N), "check_ms": c_ms,
                 "check_bound_ms": c_bound[0], "check_mean_leaves": c_leaves / CHAINS})
    # body 4 at kDiag: 2m's input, and L0's final state
    l0_line, l0_state = lr["L0"]
    ms4, src4, ev4, leaves4 = traj_time(sg_args, "diag")
    m_ms, _, _, m_leaves = traj_time(state_args(l0_state, "diag"), "diag", reps=5)
    b4 = _bound_ms(leaves4, 256, N, "diag", "spiked_gaussian", k)
    mb4 = _bound_ms(m_leaves, CHAINS, N, "diag", "spiked_gaussian", k)
    rows.append({"name": "nuts_trajectory", "metric": "diag", "body": "spiked_gaussian",
                 "route": "cuda", "source": traj_src, "replaces": traj_tpu,
                 "launches": l0_line["kernel_launches"]["trajectory"],
                 "max_abs_err": sg_cmp[0], "ms": ms4, "ms_source": src4, "events_ms": ev4,
                 "chains": 256, "plain_ms": sg_cmp[1], "bound_ms": b4[0], "bound_by": b4[1],
                 "library_ms": None, "main_chains": CHAINS, "main_ms": m_ms,
                 "main_bound_ms": mb4[0], "main_mean_leaves": m_leaves / CHAINS})
    # body 4 in the HMC kernel, 2m's input
    hkw = dict(spec=spec, Emax=1000.0)
    h_ev = _cuda_time_ms(lambda: hmc_trajectory(*sg_hargs, (3, 8), **hkw), reps=20, warmup=2)
    h_ms, h_src = _device_ms(lambda: hmc_trajectory(*sg_hargs, (3, 8), **hkw),
                             "hmc_trajectory", 20, h_ev)
    hb = _hmc_bound_ms(int(sg_hargs[5].sum()), 256, N, "spiked_gaussian", k)
    rows.append({"name": "hmc_trajectory", "metric": "diag", "body": "spiked_gaussian",
                 "route": "cuda", "source": "littlemcmc_torch/ops/csrc/hmc_trajectory.cu",
                 "replaces": "littlemcmc_tpu/ops/hmc_trajectory_pallas.py:273", "launches": 0,
                 "max_abs_err": sg_hmc_cmp[0], "ms": h_ms, "ms_source": h_src,
                 "events_ms": h_ev, "chains": 256, "plain_ms": sg_hmc_cmp[1],
                 "bound_ms": hb[0], "bound_by": hb[1], "library_ms": None})
    # the fused kernels' low-rank branch
    for step, label, op in (("nuts", "L1", fused_nuts), ("hmc", "L3", fused_hmc)):
        (k_ms, p_ms, _, work, ev_ms), err = lr_fused[step]
        bound = _fused_diag_bound_ms(work, 256, N, 2, False, "spiked_gaussian", step, k,
                                     _fac_rank(_model_fac(sg, DEVICE), N))
        line, state = lr[label]
        pot, da = state.potential, state.da
        fac = _shared_lowrank_factor(pot, True)
        fargs = (state.q, state.q_grad, state.logp, state.iter_count.float(), da.log_step,
                 da.log_bar, da.hbar, da.count.float(), da.mu, pot.var.contiguous(), None)
        fkw = dict(spec=spec, T=250, tuning=False, metric="lowrank", fac=fac,
                   config=NUTSConfig() if step == "nuts" else HMCConfig(),
                   chain_block=CHAIN_BLOCK)
        work_c = int(op(*fargs, (5, 9), **fkw)[FUSED_STEPS[step]["work"]].sum())
        c_ev = _cuda_time_ms(lambda: op(*fargs, (5, 9), **fkw), reps=3, warmup=0)
        c_ms, c_src = _device_ms(lambda: op(*fargs, (5, 9), **fkw), f"fused_{step}", 3, c_ev)
        c_bps = last_blocks_per_sm(f"fused_{step}")
        c_bound = _fused_diag_bound_ms(work_c, CHAINS, N, 250, False, "spiked_gaussian", step,
                                       k, _fac_rank(fac, N))
        rows.append({"name": f"fused_{step}", "metric": "lowrank", "body": "spiked_gaussian",
                     "route": "cuda",
                     "source": f"littlemcmc_torch/ops/csrc/fused_{step}.cu",
                     "replaces": ("littlemcmc_tpu/ops/fused_nuts_pallas.py:978" if step == "nuts"
                                  else "littlemcmc_tpu/ops/fused_hmc_pallas.py:511"),
                     "launches": line["kernel_launches"][f"fused_{step}"], "max_abs_err": err,
                     "ms": k_ms, "events_ms": ev_ms, "chains": 256, "draws": 2,
                     "plain_ms": p_ms, "bound_ms": bound[0], "bound_by": bound[1],
                     "library_ms": None, "chunk_draws": 250, "chunk_ms": c_ms,
                     "chunk_ms_source": c_src, "chunk_bound_ms": c_bound[0],
                     "chunk_bound_by": c_bound[1], "chunk_blocks_per_sm": c_bps})
    _fused_path_breakdown(sg, "nuts", dict(model_ndim=N, chains=CHAINS, tune=TUNE, draws=DRAWS,
                                           init="jitter+adapt_lowrank"),
                          draw_chunks=4, label="_lowrank")
    _fused_path_breakdown(sg, "hmc", dict(model_ndim=N, chains=CHAINS, tune=TUNE, draws=DRAWS,
                                          init="jitter+adapt_lowrank",
                                          step=HamiltonianMC(model_ndim=N)),
                          draw_chunks=4, label="_lowrank")
    _breakdown(sg, l2_state, gen, label="_lowrank_per_draw", pooled=True)
    _line(phase="lowrank_timing_done", elapsed_s=f"{time.perf_counter() - t_start:.1f}")
    return rows


def _funnel_auto_checks(f, hr, t_start) -> dict:
    """Phases 2o-2r: the funnel body (5) in the four kernels against their
    plain versions at 1024 chains; the probe matrix's nine generated bodies
    and ``HierarchicalRegression``'s through ``probe_specs`` on the card;
    the generated body in the per-draw NUTS kernel against its plain
    version at ``HierarchicalRegression``'s shapes, 1024 chains. ``f``: the
    centred funnel; ``hr``: a ``HierarchicalRegression`` (its spec traced
    here). Returns what the kernels line needs."""
    import torch
    from littlemcmc_torch.models.probe_matrix import autospec_matrix
    from littlemcmc_torch.ops.autospec import make_trajectory_spec, probe_spec, probe_specs

    out = {}
    # 2o. the per-draw kernels with body 5 (a quarter of the chains in the
    # neck; energies of divergent and far-off trajectories held scaled)
    out["f_args"] = _posterior_inputs(f, CHAINS, 0.2, seed=33)
    out["f_traj"] = _compare("funnel", f, out["f_args"], (197, -5), need=0.99,
                             share=PLAIN_SHARE)
    out["f_hargs"] = _hmc_inputs(f, None, CHAINS, 0.15, 34)
    out["f_hmc"] = _compare_hmc(f, out["f_hargs"], (199, 3), need=0.99, scaled=True)
    # 2p. the fused kernels' kDiag instance with body 5: a 2-draw draw chunk
    # and a 2-draw tune chunk with the Welford steps (a window swap at draw
    # 1) and dual averaging on
    out["f_fused"] = {}
    for step in ("nuts", "hmc"):
        draw = _compare_fused(2, False, True, 35, (211, 7), step, f, "diag")
        tune = _compare_fused(2, True, True, 36, (223, 11), step, f, "diag")
        out["f_fused"][step] = (draw, max(draw[2], tune[2]))
    _line(phase="funnel_checks", elapsed_s=f"{time.perf_counter() - t_start:.1f}")
    # 2q. the probe matrix and the hierarchical body, one probe build
    dev = torch.device(DEVICE)
    specs = [make_trajectory_spec(ndim=3, logp_fn=fn, device=dev, name=name)
             for name, fn in autospec_matrix(dev).items()]
    specs.append(hr.trajectory_spec())
    t0 = time.perf_counter()
    launches = probe_spec.launches
    report = probe_specs(specs)
    print(json.dumps({"phase": "autospec_probes", "bodies": len(specs),
                      "launches": probe_spec.launches - launches,
                      "build_and_probe_seconds": time.perf_counter() - t0,
                      "passed": sorted(report), "errors": report}), flush=True)
    out["probe_err"] = max(max(r.values()) for r in report.values())
    # 2r. the generated body in the per-draw NUTS kernel, 1024 chains near
    # the reference posterior
    out["h_args"] = _posterior_inputs(hr, CHAINS, 0.3, seed=37)
    out["h_traj"] = _compare("hierarchical", hr, out["h_args"], (227, -13), need=0.99,
                             share=PLAIN_SHARE)
    _line(phase="autospec_checks", elapsed_s=f"{time.perf_counter() - t_start:.1f}")
    return out


def _funnel_quality(trace, stats, report, label, card, extra) -> dict:
    """F1's gates, the JAX suite's envelope for the centred funnel
    (``scripts/bench_suite.py:216-230``): max split R-hat <= 1.35, the
    divergence rate off the neck (v >= -2) <= 0.025, v's sd >= 2.13 and
    the divergence rate <= 0.045; v's quantiles and the neck's share
    printed beside the JAX study's arms (``FUNNEL_DIVERGENCE_STUDY.json``:
    512 chains, 1000 + 3000, on a TPU and a CPU, not on this card)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from littlemcmc_torch.utils.diagnostics import ess_bulk, split_rhat

    n = trace.shape[-1]
    if not np.isfinite(trace).all():
        raise RuntimeError(f"{label}: non-finite trace")
    with ThreadPoolExecutor(8) as pool:
        ess = list(pool.map(lambda i: ess_bulk(trace[:, :, i]), range(n)))
        rhat = list(pool.map(lambda i: split_rhat(trace[:, :, i]), range(n)))
    v = trace[..., 0].reshape(-1)
    div = stats["diverging"].reshape(-1)
    neck = v < -2.0
    secs = report["sample_seconds"]
    line = {"phase": label, "engine": report["engine"], "trajectory": report["trajectory"],
            "chains": trace.shape[0], "ndim": n, "draws": trace.shape[1], **extra,
            "sample_seconds": secs, "min_bulk_ess": float(min(ess)),
            "min_bulk_ess_per_s": float(min(ess)) / secs, "max_split_rhat": float(max(rhat)),
            "divergence_rate": float(div.mean()), "v_sd": float(v.std()),
            "v_mean": float(v.mean()), "v_q05": float(np.percentile(v, 5)),
            "v_q95": float(np.percentile(v, 95)), "p_neck": float(neck.mean()),
            "p_div_given_neck": float(div[neck].mean()) if neck.any() else 0.0,
            "p_div_given_not_neck": float(div[~neck].mean()),
            "mean_depth": float(stats["depth"].mean()),
            "step_size": float(stats["step_size"][:, -1].mean()),
            "jax_study_arms": "divergence rate 0.024-0.039, v sd 2.50-2.58 (TPU and CPU runs)",
            "card": card}
    print(json.dumps(line), flush=True)
    _check_gates(label, [("max split R-hat <= 1.35", line["max_split_rhat"] <= 1.35),
                         ("p_div_given_not_neck <= 0.025", line["p_div_given_not_neck"] <= 0.025),
                         ("v sd >= 2.13", line["v_sd"] >= 2.13),
                         ("divergence rate <= 0.045", line["divergence_rate"] <= 0.045)])
    return line


# the TPU kernel each fused probe replaces: the pallas_call of its JAX probe
PROBE_REPLACES = {"cos": 77, "grid_scratch": 112, "smem_accumulate": 165, "thin_factor": 226,
                  "stat_io_layout": 302, "block_outputs_3d": 381}


def _probe_work(name: str) -> tuple[float, float]:
    """``(fp32 operations, bytes)`` of one launch of fused probe ``name``:
    its inputs read once, its outputs written once."""
    from littlemcmc_torch.ops.fused_probe import PROBES

    T, B, R, N, K = PROBES[name]
    return {
        "cos": (3 * R * N, 8 * R * N),
        "grid_scratch": (2 * R * N * (T - 1), 4 * R * N),
        "smem_accumulate": (T * (2 * R + 1) * N * N, 4 * (R * N + N * N + 1)),
        "thin_factor": (4 * R * N * K + 2 * R * N, 4 * (2 * R * N + 16 * N)),
        "stat_io_layout": (T * B * R * (2 * N + 7),
                           4 * (2 + B * R * N + B * R * K + R * N)
                           + 4 * (T * B * R * N + T * B * R * 3 + B * R * N + B * R * K)),
        "block_outputs_3d": (B * T * N * N + B * 8 * N, 4 * B * (16 * N + N * N)),
    }[name]


def _fused_probe_checks(t_start) -> dict:
    """Phase 2s: the six fused-kernel capability probes (``csrc/fused_probe.cu``)
    on the card against their plain versions at the JAX probes' tolerances
    (``check_probe``), each timed: ``ms`` its device time a launch, ``plain_ms``
    its plain version's a call (CUDA events), and its bound. name -> row."""
    import torch
    from littlemcmc_torch.ops.fused_probe import (PROBES, check_probe, probe_inputs,
                                                  probe_kernel, probe_plain)

    dev = torch.device(DEVICE)
    out = {}
    for name in PROBES:
        err = check_probe(name, dev)
        inputs = probe_inputs(name, dev)
        ev = _cuda_time_ms(lambda: probe_kernel(name, inputs, dev), reps=20, warmup=2)
        ms, src = _device_ms(lambda: probe_kernel(name, inputs, dev), f"probe_{name}_kernel",
                             20, ev)
        plain_ms = _cuda_time_ms(lambda: probe_plain(name, inputs, dev), reps=5, warmup=1)
        bound = _roofline_ms(*_probe_work(name))
        out[name] = {"name": f"fused_probe_{name}", "route": "cuda",
                     "source": "littlemcmc_torch/ops/csrc/fused_probe.cu",
                     "replaces": f"littlemcmc_tpu/ops/fused_probe.py:{PROBE_REPLACES[name]}",
                     "launches": 0, "max_abs_err": err, "ms": ms, "ms_source": src,
                     "events_ms": ev, "plain_ms": plain_ms, "bound_ms": bound[0],
                     "bound_by": bound[1], "library_ms": None}
    _line(phase="fused_probe_checks", **{f"{k}_max_abs_err": v["max_abs_err"]
                                         for k, v in out.items()},
          elapsed_s=f"{time.perf_counter() - t_start:.1f}")
    return out


def _probe_launches(fused: bool, lowrank: bool) -> dict:
    """The fused probes' launch counts since the last reset, checked against
    one launch of each probe the election runs: the fused engine's five
    (``fused``) and the low-rank one (``lowrank``)."""
    from littlemcmc_torch.ops.fused_probe import FUSED_ENGINE_PROBES, probe_kernel

    got = dict(probe_kernel.launches)
    want = {k: int(fused and k in FUSED_ENGINE_PROBES) + int(lowrank and k == "thin_factor")
            for k in got}
    if got != want:
        raise RuntimeError(f"fused probe launches {got}, expected {want}")
    return got


def _funnel_auto_cells(smi, reset_counts, counts, t_start) -> dict:
    """Phases 3s-3u, seed 42, 1024 chains, each driven with the launch
    counts set to 0 just before and read just after: F1, the centred
    funnel, 500 + 1000, target_accept 0.9, on ``fused_diag`` (the fused
    NUTS kernel's body 5); F2, the non-centred funnel, the same sizes,
    default target, ``fused_diag`` on body 0; H1, ``HierarchicalRegression``,
    500 + ``H1_DRAWS``, target_accept 0.9, on ``per_draw_diag`` with the
    generated body (its probe launched once before the first kernel
    launch)."""
    from littlemcmc_torch import NUTS, sample
    from littlemcmc_torch.models import HierarchicalRegression, NealsFunnel, NonCenteredFunnel
    from littlemcmc_torch.ops.autospec import probe_spec
    from littlemcmc_torch.utils.diagnostics import split_rhat

    out = {}
    n_chunks = -(-TUNE // 250) - (-DRAWS // 250)
    f = NealsFunnel(10)
    reset_counts()
    rep = {}
    tr, st, out["f1_state"] = sample(f.logp_grad, model_ndim=10, chains=CHAINS, tune=TUNE,
                                     draws=DRAWS, random_seed=42,
                                     step=NUTS(model_ndim=10, target_accept=0.9),
                                     perf_report=rep, return_final_state=True,
                                     progressbar=False, compute_convergence_checks=False)
    got = {k: v for k, v in counts().items() if v}
    if rep["engine"] != "fused_diag" or got != {"fused_nuts": n_chunks}:
        raise RuntimeError(f"F1: engine {rep['engine']}, launches {got}")
    out["f1_probes"] = _probe_launches(fused=True, lowrank=False)
    out["f1"] = _funnel_quality(tr, st, rep, "F1_funnel_centred", smi,
                                {"kernel_launches": got, "probe_launches": out["f1_probes"],
                                 "tune": TUNE, "target_accept": 0.9})
    out["f"] = f
    ncf = NonCenteredFunnel(10)
    reset_counts()
    rep = {}
    tr, st = sample(ncf.logp_grad, model_ndim=10, chains=CHAINS, tune=TUNE, draws=DRAWS,
                    random_seed=42, perf_report=rep, progressbar=False,
                    compute_convergence_checks=False)
    got = {k: v for k, v in counts().items() if v}
    if rep["engine"] != "fused_diag" or got != {"fused_nuts": n_chunks}:
        raise RuntimeError(f"F2: engine {rep['engine']}, launches {got}")
    f2_probes = _probe_launches(fused=True, lowrank=False)
    rhat = max(split_rhat(tr[:, :, i]) for i in range(10))
    v_sd = float(ncf.transform(tr)[..., 0].std())
    line = _quality(ncf, tr, st, rep["sample_seconds"], rep, "F2_funnel_noncentred", smi,
                    {"kernel_launches": got, "probe_launches": f2_probes,
                     "max_split_rhat": float(rhat),
                     "funnel_v_sd": v_sd, "funnel_v_sd_exact": 3.0}, gated=False)
    _check_gates("F2_funnel_noncentred", [
        ("max split R-hat < 1.05", rhat < 1.05),
        ("divergence_rate < 0.01", line["divergence_rate"] < 0.01),
        ("0.9 <= posterior_var_ratio <= 1.1", 0.9 <= line["posterior_var_ratio"] <= 1.1),
        ("max |mean| / sd < 0.1", line["max_abs_mean_over_sd"] < 0.1),
        ("min bulk ESS > 1000", line["min_bulk_ess"] > 1000),
        ("funnel-space v sd within 10% of 3", abs(v_sd / 3.0 - 1.0) < 0.1)])
    out["f2"] = line
    _line(phase="funnel_cells", elapsed_s=f"{time.perf_counter() - t_start:.1f}")
    hr = HierarchicalRegression()  # a fresh instance: its body is probed in this run
    reset_counts()
    probe_spec.launches = 0
    rep = {}
    tr, st, out["h1_state"] = sample(hr.logp_grad, model_ndim=hr.ndim, chains=CHAINS,
                                     tune=TUNE, draws=H1_DRAWS, random_seed=42,
                                     step=NUTS(model_ndim=hr.ndim, target_accept=0.9),
                                     perf_report=rep, return_final_state=True,
                                     progressbar=False, compute_convergence_checks=False)
    got = {k: v for k, v in counts().items() if v}
    got["autospec_probe"] = probe_spec.launches
    if (rep["engine"] != "per_draw_diag"
            or rep["trajectory"] != ("cuda" if DEVICE == "cuda" else "plain")
            or got != {"trajectory": TUNE + H1_DRAWS, "autospec_probe": 1}):
        raise RuntimeError(f"H1: engine {rep['engine']}, trajectory {rep['trajectory']}, "
                           f"launches {got}")
    out["h1"] = _logistic_quality(tr, st, rep, "H1_hierarchical_generated", smi,
                                  {"kernel_launches": got, "target_accept": 0.9},
                                  tune=TUNE, draws=H1_DRAWS, ref=_hier_reference())
    out["hr"] = hr
    out["h1_launches"] = got
    _line(phase="autospec_cell", elapsed_s=f"{time.perf_counter() - t_start:.1f}")
    return out


def _tree_draw_ms(model, state, gen, draws: int) -> dict:
    """ms a draw of NUTS on the tensor-op tree, the model's own batched
    ``(logp, grad)`` at every leaf, over ``draws`` draws from ``state`` on
    CUDA events (no profiler: the tree issues about 12,000 device kernels a
    draw of the hierarchical model, which the profiler takes minutes to
    collect)."""
    import torch
    from littlemcmc_torch.base import NUTSConfig
    from littlemcmc_torch.nuts import build_nuts_kernel

    kernel = build_nuts_kernel(NUTSConfig(), None, batched_logp_grad_fn=model.batched_logp_grad)
    state, _ = kernel(state, False, gen, (1, 2))  # warm-up
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(draws):
        state, _ = kernel(state, False, gen, (100 + i, 7))
    end.record()
    end.synchronize()
    line = {"phase": "tree_timing_hierarchical", "draws": draws,
            "ms_per_draw": start.elapsed_time(end) / draws}
    print(json.dumps(line), flush=True)
    return line


def _funnel_auto_timing(chk, cells, gen, t_start) -> list:
    """Phase 4h: the funnel body's kernels (the fused NUTS kDiag instance
    per 250-draw chunk and the per-draw NUTS kernel per launch, both at
    F1's final state), the generated body in ``nuts_trajectory`` per launch
    at H1's final state, the tree on the same model (ms a draw over 20
    draws from that state), where a post-tune H1 draw spends its time, and
    the probe kernel alone; then the kernels line's rows of this slice."""
    import torch
    from littlemcmc_torch.ops.autospec import _probe_inputs, run_probe, scratch_in_smem
    from littlemcmc_torch.ops.hmc_trajectory import hmc_trajectory
    from littlemcmc_torch.ops.nuts_trajectory import trajectory

    f = cells["f"]
    f_line = _es_kernel_timing(f, cells["f1_state"], cells["f1_state"], "nuts", gen,
                               label="funnel")
    hr = cells["hr"]
    spec = hr.trajectory_spec()
    prog = spec.auto
    s = cells["h1_state"]
    C, n = s.q.shape
    eps = torch.exp(s.da.log_bar)
    targs = (s.q.contiguous(), s.potential.sample_momentum(gen), s.q_grad.contiguous(),
             s.logp.contiguous(), eps, torch.full((C,), DEPTH, dtype=torch.int32, device=DEVICE),
             s.potential.var.contiguous())
    kw = dict(spec=spec, max_treedepth=DEPTH, Emax=1000.0, chain_block=CHAIN_BLOCK)
    pout = trajectory(*targs, (3, 8), **kw)
    h_bound = _bound_ms(int(pout["n_leaves"].sum()), C, n, body="auto", rows=spec.rows,
                        ir_ops=prog.flops)
    h_events = _cuda_time_ms(lambda: trajectory(*targs, (3, 8), **kw), reps=20, warmup=3)
    h_ms, h_src = _device_ms(lambda: trajectory(*targs, (3, 8), **kw), "nuts_trajectory", 20,
                             h_events)
    in_smem = scratch_in_smem(spec, "nuts_trajectory")
    tree = _tree_draw_ms(hr, s, gen, draws=20)
    kern = _breakdown(hr, s, gen, draws=50, label="_hierarchical_generated")
    q = _probe_inputs(n, torch.device(DEVICE))
    p_events = _cuda_time_ms(lambda: run_probe(spec, q), reps=20, warmup=2)
    p_ms, p_src = _device_ms(lambda: run_probe(spec, q), "autospec_probe", 20, p_events)
    p_plain = _cuda_time_ms(lambda: prog.plain(q), reps=20, warmup=2)
    p_bound = _roofline_ms(q.shape[0] * prog.flops,
                           4 * (q.numel() + spec.rows) + 4 * (q.shape[0] + q.numel()))
    line = {"phase": "autospec_timing", "chains": C, "ms": h_ms, "ms_source": h_src,
            "events_ms": h_events, "bound_ms": h_bound[0], "bound_by": h_bound[1],
            "leaves_per_chain": float(pout["n_leaves"].float().mean()),
            "program_ops": len(prog.instrs), "program_flops": prog.flops,
            "const_floats": spec.rows, "scratch_floats": prog.scratch_floats,
            "scratch_in_smem": in_smem,
            "program_loops": sum(st.shape is not None and not st.rows for st in prog.steps),
            "tree_ms_per_draw": tree["ms_per_draw"],
            "generated_ms_per_draw": kern["ms_per_draw"],
            "tree_over_generated": tree["ms_per_draw"] / kern["ms_per_draw"],
            "probe_ms": p_ms, "probe_ms_source": p_src, "probe_plain_ms": p_plain,
            "probe_bound_ms": p_bound[0], "probe_bound_by": p_bound[1]}
    print(json.dumps(line), flush=True)
    _line(phase="autospec_timing_done", elapsed_s=f"{time.perf_counter() - t_start:.1f}")

    traj_src, traj_tpu = ("littlemcmc_torch/ops/csrc/nuts_trajectory.cu",
                          "littlemcmc_tpu/ops/nuts_trajectory_pallas.py:1023")
    body_tpu = "littlemcmc_tpu/models/funnel.py:54"
    k_err, k_plain = chk["f_traj"]
    rows = [
        # body 5 in the per-draw NUTS kernel: ms at F1's final state;
        # plain_ms and max_abs_err at 2o's input (1024 chains); no cell
        # runs the funnel per draw
        {"name": "nuts_trajectory", "metric": "diag", "body": "funnel", "route": "cuda",
         "source": traj_src, "replaces": f"{traj_tpu} (body {body_tpu})", "launches": 0,
         "max_abs_err": k_err, "ms": f_line["per_draw_ms"],
         "ms_source": f_line["per_draw_ms_source"], "plain_ms": k_plain,
         "bound_ms": f_line["per_draw_bound_ms"], "bound_by": f_line["per_draw_bound_by"],
         "library_ms": None},
    ]
    for step in ("nuts", "hmc"):
        (k_ms, p_ms2, _, work, ev_ms), err = chk["f_fused"][step]
        bound = _fused_diag_bound_ms(work, CHAINS, 10, 2, False, "funnel", step)
        row = {"name": f"fused_{step}", "metric": "diag", "body": "funnel", "route": "cuda",
               "source": f"littlemcmc_torch/ops/csrc/fused_{step}.cu",
               "replaces": ("littlemcmc_tpu/ops/fused_nuts_pallas.py:978" if step == "nuts"
                            else "littlemcmc_tpu/ops/fused_hmc_pallas.py:511")
               + f" (body {body_tpu})",
               "launches": cells["f1"]["kernel_launches"]["fused_nuts"] if step == "nuts" else 0,
               "max_abs_err": err, "ms": k_ms, "events_ms": ev_ms, "draws": 2,
               "plain_ms": p_ms2, "bound_ms": bound[0], "bound_by": bound[1],
               "library_ms": None}
        if step == "nuts":
            row.update(chunk_draws=250, chunk_ms=f_line["fused_ms"],
                       chunk_bound_ms=f_line["fused_bound_ms"],
                       chunk_bound_by=f_line["fused_bound_by"])
        rows.append(row)
    h_err, h_plain = chk["f_hmc"]
    hb = _hmc_bound_ms(int(chk["f_hargs"][5].sum()), CHAINS, 10, body="funnel")
    h_call = lambda: hmc_trajectory(*chk["f_hargs"], (3, 5),  # noqa: E731
                                    spec=f.trajectory_spec(), Emax=1000.0)
    h_ev = _cuda_time_ms(h_call, reps=10, warmup=2)
    h_t, h_t_src = _device_ms(h_call, "hmc_trajectory", 10)
    rows.append({"name": "hmc_trajectory", "metric": "diag", "body": "funnel", "route": "cuda",
                 "source": "littlemcmc_torch/ops/csrc/hmc_trajectory.cu",
                 "replaces": f"littlemcmc_tpu/ops/hmc_trajectory_pallas.py:273 (body {body_tpu})",
                 "launches": 0, "max_abs_err": h_err, "ms": h_t, "ms_source": h_t_src,
                 "events_ms": h_ev,
                 "plain_ms": h_plain, "bound_ms": hb[0], "bound_by": hb[1], "library_ms": None})
    a_err, a_plain = chk["h_traj"]
    rows += [
        # the generated body in the per-draw NUTS kernel: ms and bound at
        # H1's final state, plain_ms and max_abs_err at 2r's input
        {"name": "nuts_trajectory", "metric": "diag", "body": "auto (HierarchicalRegression)",
         "route": "cuda", "source": traj_src + " + ops/autospec.py (generated body)",
         "replaces": "littlemcmc_tpu/ops/autospec.py:540 (body of make_pallas_model_spec :411)",
         "launches": cells["h1_launches"]["trajectory"], "max_abs_err": a_err,
         "ms": h_ms, "ms_source": h_src, "events_ms": h_events, "plain_ms": a_plain,
         "bound_ms": h_bound[0], "bound_by": h_bound[1], "library_ms": None,
         "tree_ms_per_draw": tree["ms_per_draw"], "scratch_in_smem": in_smem},
        # the probe kernel alone: 8 chains at the probe's inputs
        {"name": "autospec_probe", "body": "auto (HierarchicalRegression)", "route": "cuda",
         "source": "littlemcmc_torch/ops/csrc/autospec_probe.cu",
         "replaces": "littlemcmc_tpu/ops/autospec.py:540",
         "launches": cells["h1_launches"]["autospec_probe"], "max_abs_err": chk["probe_err"],
         "ms": p_ms, "ms_source": p_src, "plain_ms": p_plain, "bound_ms": p_bound[0],
         "bound_by": p_bound[1], "library_ms": None},
    ]
    return rows


def _surface_cells(smi, cg, lin, sv, reset_counts, counts, t_start) -> dict:
    """Phases 3v-3y: the rest of the one-card ``sample()`` surface and the
    two generated-body models.

    3v. ``checkpoint_resume``: the 100-d main path (1024 chains, 100 + 150)
    with ``checkpoint_every=50``, interrupted by a callback at iteration
    150, then resumed; once on the default per-draw engine, once with
    ``fuse_draws=True``. Gates: the partial and the resumed traces equal an
    uninterrupted run's bits, checkpoints at 50, 100 and 150. Then the
    save and restore seconds of the final state.
    3w. ``device_trace``: the main path at 50 + 50 inside
    :func:`~littlemcmc_torch.utils.profiling.device_trace`. Gate: one
    device record of the trajectory kernel for each launch
    ``perf_report`` counts.
    3x. ``linear_regression``: ``LinearRegression()``, 1024 chains, 500 +
    1000 on the generated body. Gates: each posterior mean within 0.1
    posterior sd of the flat-prior closed form, R-hat < 1.01, divergences
    < 1%.
    3y. ``stochastic_volatility``: ``StochasticVolatility()`` (T = 128),
    1024 chains, 500 + 1000, ``target_accept=0.95``, on the generated body.
    Gates: the globals' R-hat < 1.05, divergences < 2%, the latent path's
    posterior mean correlated > 0.85 with the true path. Then T = 500 for
    10 + 10 draws on the tree (its decline reason and ms a draw, ungated).
    """
    import os
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from littlemcmc_torch import NUTS, sample
    from littlemcmc_torch.models import StochasticVolatility
    from littlemcmc_torch.ops.autospec import probe_spec
    from littlemcmc_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
    from littlemcmc_torch.utils.diagnostics import ess_bulk, split_rhat
    from littlemcmc_torch.utils.profiling import device_trace

    out = {}
    # 3v. checkpoint, interrupt and resume against an uninterrupted run
    kw = dict(model_ndim=N, chains=CHAINS, tune=CK_TUNE, draws=CK_DRAWS, random_seed=42,
              progressbar=False, compute_convergence_checks=False)
    for fuse, engine in ((None, "per_draw_diag"), (True, "fused_diag")):
        d = tempfile.mkdtemp(prefix="lmc_ckpt_")
        seen = []

        def interrupt(iteration, tuning, states, chunk, n_divergences):
            seen.append(iteration)
            if iteration >= CK_STOP:
                raise KeyboardInterrupt

        try:
            launches, reports = [], []
            runs = (dict(checkpoint_dir=d, checkpoint_every=CK_EVERY, callback=interrupt),
                    dict(checkpoint_dir=d, resume=True), dict(return_final_state=True))
            results = []
            for extra in runs:
                reset_counts()
                rep = {}
                results.append(sample(cg.logp_grad, fuse_draws=fuse, perf_report=rep,
                                      **extra, **kw))
                launches.append({k: v for k, v in counts().items() if v})
                reports.append(rep)
            part, rest, (full, _, state) = results[0][0], results[1][0], results[2]
            ckpts = sorted(os.listdir(d))
            t0 = time.perf_counter()
            path = save_checkpoint(os.path.join(d, "timed"), state, CK_TUNE + CK_DRAWS,
                                   extra={"generator": torch.Generator(device=DEVICE)
                                          .manual_seed(1).get_state()})
            save_s = time.perf_counter() - t0
            nbytes = os.path.getsize(os.path.join(path, "state.pt"))
            t0 = time.perf_counter()
            back, _ = restore_checkpoint(path, state)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            same_state = bool(torch.equal(back.q, state.q)
                              and torch.equal(back.potential.var, state.potential.var))
        finally:
            shutil.rmtree(d, ignore_errors=True)
        same = bool(np.array_equal(np.concatenate([part, rest], axis=1), full))
        line = {"phase": f"checkpoint_resume_{engine}", "engine": reports[0]["engine"],
                "callbacks_at": seen, "checkpoints": ckpts,
                "partial_draws": part.shape[1], "resumed_draws": rest.shape[1],
                "launches_interrupted": launches[0], "launches_resumed": launches[1],
                "launches_uninterrupted": launches[2], "bits_equal": same,
                "sample_seconds": [r["sample_seconds"] for r in reports],
                "save_seconds": save_s, "restore_seconds": restore_s,
                "checkpoint_bytes": nbytes, "restored_equal": same_state, "card": smi}
        print(json.dumps(line), flush=True)
        _check_gates(line["phase"], [
            ("engine", all(r["engine"] == engine for r in reports)),
            ("resumed traces equal an uninterrupted run's bits", same),
            ("checkpoints at 50, 100, 150",
             ckpts == [f"step_{k:08d}" for k in (50, 100, 150)]),
            ("partial and resumed draws", (part.shape[1], rest.shape[1])
             == (CK_STOP - CK_TUNE, CK_TUNE + CK_DRAWS - CK_STOP)),
            ("restored state equal", same_state)])
        out[engine] = line

    # 3w. one device record a launch of the main path
    d = tempfile.mkdtemp(prefix="lmc_trace_")
    try:
        reset_counts()
        rep = {}
        t0 = time.perf_counter()
        with device_trace(d) as tr:
            sample(cg.logp_grad, model_ndim=N, chains=CHAINS, tune=TR_TUNE, draws=TR_DRAWS,
                   random_seed=42, perf_report=rep, progressbar=False,
                   compute_convergence_checks=False)
        wall_s = time.perf_counter() - t0
        trace_bytes = os.path.getsize(tr.path)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    recs = tr.kernel_records("nuts_trajectory")
    busy = tr.busy_ms()
    line = {"phase": "device_trace", "engine": rep["engine"],
            "kernel_launches": rep["kernel_launches"], "device_records": recs,
            "all_device_records": sum(tr.records.values()),
            "launches_by_counter": tr.launches, "sample_seconds": rep["sample_seconds"],
            "device_busy_ms": busy, "device_busy_share": busy / (1e3 * rep["sample_seconds"]),
            "window_seconds": wall_s, "trace_bytes": trace_bytes, "card": smi}
    print(json.dumps(line), flush=True)
    _check_gates("device_trace", [
        ("one device record a launch",
         recs == rep["kernel_launches"]["nuts_trajectory"] == TR_TUNE + TR_DRAWS)])
    out["device_trace"] = line

    def cell(model, label, target, gates_fn):
        reset_counts()
        probes0 = probe_spec.launches
        rep = {}
        tr_, st, fs = sample(model.logp_grad, model_ndim=model.ndim, chains=CHAINS, tune=TUNE,
                             draws=DRAWS, random_seed=42,
                             step=NUTS(model_ndim=model.ndim, target_accept=target),
                             perf_report=rep, return_final_state=True, progressbar=False,
                             compute_convergence_checks=False)
        got = {k: v for k, v in counts().items() if v}
        got["autospec_probe"] = probe_spec.launches - probes0
        with ThreadPoolExecutor(8) as pool:
            ess = list(pool.map(lambda i: ess_bulk(tr_[:, :, i]), range(model.ndim)))
            rhat = list(pool.map(lambda i: split_rhat(tr_[:, :, i]), range(model.ndim)))
        secs = rep["sample_seconds"]
        line = {"phase": label, "engine": rep["engine"], "trajectory": rep["trajectory"],
                "chains": CHAINS, "ndim": model.ndim, "tune": TUNE, "draws": DRAWS,
                "target_accept": target, "kernel_launches": got, "sample_seconds": secs,
                "transitions_per_s": CHAINS * (TUNE + DRAWS) / secs,
                "min_bulk_ess": float(min(ess)), "min_bulk_ess_per_s": float(min(ess)) / secs,
                "max_rhat": float(max(rhat)),
                "divergence_rate": float(st["diverging"].mean()),
                "mean_tree_size": float(st["tree_size"].mean()),
                "mean_depth": float(st["depth"].mean()),
                "step_size": float(st["step_size"][:, -1].mean()), "card": smi}
        gates = [("engine per_draw_diag on the generated body",
                  rep["engine"] == "per_draw_diag" and rep["trajectory"] == "cuda"),
                 ("launches", got == {"trajectory": TUNE + DRAWS, "autospec_probe": 1})]
        gates += gates_fn(tr_, st, line, ess, rhat)
        print(json.dumps(line), flush=True)
        _check_gates(label, gates)
        return line, fs, tr_

    def lin_gates(tr_, st, line, ess, rhat):
        exact = lin.posterior_moments()
        flat = tr_.reshape(-1, lin.ndim)
        err = np.abs(flat.mean(0) - exact["mean"]) / exact["sd"]
        line.update(mean=flat.mean(0).tolist(), exact_mean=exact["mean"].tolist(),
                    sd=flat.std(0).tolist(), exact_sd=exact["sd"].tolist(),
                    max_mean_err_in_sd=float(err.max()))
        return [("means within 0.1 sd of the closed form", bool((err < 0.1).all())),
                ("R-hat < 1.01", max(rhat) < 1.01),
                ("divergences < 1%", line["divergence_rate"] < 0.01)]

    def sv_gates(tr_, st, line, ess, rhat):
        flat = tr_.reshape(-1, sv.ndim)
        corr = float(np.corrcoef(flat[:, 3:].mean(0), sv.h_true)[0, 1])
        phi = np.tanh(flat[:, 0])
        line.update(globals_rhat=[float(r) for r in rhat[:3]], h_corr=corr,
                    globals_min_bulk_ess=float(min(ess[:3])), phi_mean=float(phi.mean()),
                    phi_sd=float(phi.std()), true_phi=sv.true_phi)
        return [("globals' R-hat < 1.05", max(rhat[:3]) < 1.05),
                ("divergences < 2%", line["divergence_rate"] < 0.02),
                ("corr(mean h, h_true) > 0.85", corr > 0.85)]

    out["lin"] = cell(lin, "linear_regression", 0.8, lin_gates)
    out["sv"] = cell(sv, "stochastic_volatility", SV_TARGET, sv_gates)

    # T = 500 declines at trace time and runs the tree
    big = StochasticVolatility(T=SV_BIG_T, device=DEVICE)
    reset_counts()
    rep = {}
    tr_, st = sample(big.logp_grad, model_ndim=big.ndim, chains=SV_BIG_CHAINS, tune=SV_BIG_TUNE,
                     draws=SV_BIG_DRAWS, random_seed=42,
                     step=NUTS(model_ndim=big.ndim, target_accept=SV_TARGET,
                               max_treedepth=SV_BIG_DEPTH),
                     perf_report=rep, progressbar=False, compute_convergence_checks=False)
    line = {"phase": "stochastic_volatility_T500", "max_treedepth": SV_BIG_DEPTH,
            "ndim": big.ndim, "engine": rep["engine"],
            "trajectory": rep["trajectory"], "decline_reason": big.decline_reason,
            "chains": SV_BIG_CHAINS, "tune": SV_BIG_TUNE, "draws": SV_BIG_DRAWS,
            "sample_seconds": rep["sample_seconds"],
            "ms_per_draw": 1e3 * rep["sample_seconds"] / (SV_BIG_TUNE + SV_BIG_DRAWS),
            "mean_tree_size": float(st["tree_size"].mean()),
            "finite": bool(np.isfinite(tr_).all()), "card": smi}
    print(json.dumps(line), flush=True)
    _check_gates("stochastic_volatility_T500", [
        ("the tree", rep["trajectory"] == "tensor" and big.decline_reason is not None
         and not any(counts().values()))])
    out["sv_big"] = line
    _line(phase="surface_cells", elapsed_s=f"{time.perf_counter() - t_start:.1f}")
    return out


def _surface_rows(cells, logs, gen, t_start) -> list:
    """Phase 4i: row 7's two new generated bodies in the per-draw NUTS
    kernel, each at its cell's final state: the launch against the plain
    version (on a quarter of the chains, q in the cell's posterior sds),
    its device ms, events ms and bound, and the ptxas lines of its
    ``nuts_trajectory`` instance (``logs``: the build logs)."""
    import torch
    from littlemcmc_torch.ops.nuts_trajectory import trajectory

    rows = []
    for key, seed, share in (("lin", (239, 7), PLAIN_SHARE), ("sv", (241, -3), SV_PLAIN_SHARE)):
        model = cells[f"{key}_model"]
        line, s, tr_ = cells[key]
        name = type(model).__name__
        spec = model.trajectory_spec()
        prog = spec.auto
        C, n = s.q.shape
        targs = (s.q.contiguous(), s.potential.sample_momentum(gen), s.q_grad.contiguous(),
                 s.logp.contiguous(), torch.exp(s.da.log_bar),
                 torch.full((C,), DEPTH, dtype=torch.int32, device=DEVICE),
                 s.potential.var.contiguous())
        err, plain_ms = _compare(f"auto_{name}", model, targs, seed, need=0.99, share=share,
                                 sd=tr_.reshape(-1, n).std(0))
        kw = dict(spec=spec, max_treedepth=DEPTH, Emax=1000.0, chain_block=CHAIN_BLOCK)
        pout = trajectory(*targs, seed, **kw)
        bound = _bound_ms(int(pout["n_leaves"].sum()), C, n, body="auto", rows=spec.rows,
                          ir_ops=prog.flops)
        ev = _cuda_time_ms(lambda: trajectory(*targs, seed, **kw), reps=20, warmup=3)
        ms, src = _device_ms(lambda: trajectory(*targs, seed, **kw), "nuts_trajectory", 20)
        ptxas = [ln.strip() for ln in logs[f"nuts_trajectory:{name}"].read_text().splitlines()
                 if "registers" in ln or "spill" in ln or "entry function" in ln]
        rows.append({
            "name": "nuts_trajectory", "metric": "diag", "body": f"auto ({name}, n = {n})",
            "route": "cuda",
            "source": "littlemcmc_torch/ops/csrc/nuts_trajectory.cu + ops/autospec.py "
                      "(generated body)",
            "replaces": "littlemcmc_tpu/ops/autospec.py:540 (body of make_pallas_model_spec "
                        ":411)",
            "launches": line["kernel_launches"].get("trajectory", 0), "max_abs_err": err,
            "ms": ms, "ms_source": src, "events_ms": ev, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
            "plain_chains": _plain_chains(C, share),
            "leaves_per_chain": float(pout["n_leaves"].float().mean()),
            "program_flops": prog.flops, "ptxas": ptxas})
    _line(phase="surface_rows", elapsed_s=f"{time.perf_counter() - t_start:.1f}")
    return rows


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

    from littlemcmc_torch.models import (HierarchicalRegression, LinearRegression,
                                         StochasticVolatility)
    from littlemcmc_torch.models.probe_matrix import autospec_matrix
    from littlemcmc_torch.ops.autospec import (header_source, make_trajectory_spec,
                                               probe_header)

    # the generated bodies' builds start with the sources': the
    # hierarchical body in the per-draw NUTS kernel and the probe kernel
    # (H1's, and 2q's with the probe matrix's nine bodies as well)
    t0 = time.perf_counter()
    hr = HierarchicalRegression()
    matrix = [make_trajectory_spec(ndim=3, logp_fn=fn, device=DEVICE, name=name).auto
              for name, fn in autospec_matrix(DEVICE).items()]
    hprog = hr.trajectory_spec().auto
    # the linear-regression and stochastic-volatility bodies (3x-3y), each
    # in the per-draw NUTS kernel and the probe sample() runs first
    lin, sv = LinearRegression(), StochasticVolatility()
    new_progs = {type(m).__name__: m.trajectory_spec().auto for m in (lin, sv)}
    generated = [("nuts_trajectory", header_source(hprog)),
                 ("autospec_probe", probe_header([hprog])),
                 ("autospec_probe", probe_header(matrix + [hprog]))]
    for prog in new_progs.values():
        generated += [("nuts_trajectory", header_source(prog)),
                      ("autospec_probe", probe_header([prog]))]
    trace_s = time.perf_counter() - t0
    # one nvcc a source, the static and the generated ones started together
    _build._compile(list(_build._static_jobs().values())
                    + [_build._generated_job(k, h) for k, h in generated])
    libs = _build.build_all()
    gen_logs = {f"{k}:{i}": _build._generated_job(k, h)[2]
                for i, (k, h) in enumerate(generated)}
    gen_logs.update({f"nuts_trajectory:{name}": _build._generated_job(
        "nuts_trajectory", header_source(prog))[2] for name, prog in new_progs.items()})
    _line(phase="build", seconds=f"{time.perf_counter() - t0:.1f}",
          trace_and_lower_seconds=f"{trace_s:.1f}",
          libraries=",".join(sorted(libs)) + ",generated:" + ",".join(gen_logs),
          cuda=torch.version.cuda, torch=torch.__version__,
          device=torch.cuda.get_device_name(0).replace(" ", "_"))
    logs = {name: libs[name].parent / f"{name}.log" for name in sorted(libs)}
    logs.update(gen_logs)
    for name, path in logs.items():
        for ln in path.read_text().splitlines():
            if ("registers" in ln or "spill" in ln or "entry function" in ln
                    or ln.startswith("nvcc_seconds")):
                print(f"ptxas[{name}]: {ln.strip()}", flush=True)

    from littlemcmc_torch import NUTS, HamiltonianMC, sample
    from littlemcmc_torch.base import HMCConfig, NUTSConfig
    from littlemcmc_torch.models import (CorrelatedGaussian, EightSchools, LogisticRegression,
                                         NealsFunnel, SpikedGaussian, StandardNormal)
    from littlemcmc_torch.ops.fused_hmc import fused_hmc
    from littlemcmc_torch.ops.fused_nuts import fused_nuts
    from littlemcmc_torch.ops.fused_probe import probe_kernel
    from littlemcmc_torch.ops.hmc_trajectory import hmc_trajectory, hmc_trajectory_plain
    from littlemcmc_torch.ops.logistic import logistic_logp_grad
    from littlemcmc_torch.ops.nuts_trajectory import (fused_hmc_transition,
                                                      runs_block_transition,
                                                      runs_hmc_block_transition, trajectory,
                                                      trajectory_plain)
    from littlemcmc_torch.ops.quadform import quadform_logp_grad

    ops = (trajectory, fused_nuts, hmc_trajectory, fused_hmc)
    model_ops = (logistic_logp_grad, quadform_logp_grad)

    def reset_counts():
        for op in ops + model_ops:
            op.launches = 0
        for name in probe_kernel.launches:
            probe_kernel.launches[name] = 0

    def counts():
        """The four transition kernels' launch counts (the batched model
        kernels' are read on their own)."""
        return {op.__name__: op.launches for op in ops}

    # --- 2. the kernel against its plain version -------------------------------
    cg = CorrelatedGaussian(N)
    args = _stationary_inputs(cg, np.linalg.cholesky(cg.cov), CHAINS, 0.2, seed=0)
    max_abs_err, plain_ms = _compare("correlated_gaussian", cg, args, (17, 29), need=0.99,
                                     share=PLAIN_SHARE)
    sn = StandardNormal(4)
    _compare("standard_normal", sn, _stationary_inputs(sn, np.eye(4), CHAINS, 0.5, seed=1),
             (5, 6), need=1.0, share=PLAIN_SHARE)
    # 2b. the dense branch, the true covariance as the shared metric
    dense_err, _ = _compare("correlated_gaussian", cg,
                         _dense_stationary_inputs(cg, CHAINS, 0.5, seed=2), (23, 31),
                         need=0.99, metric="dense", share=PLAIN_SHARE)
    # 2c. the fused kernel: a draw chunk, a tune chunk with the step size
    # held, and a tune chunk as the main path runs it
    fused_cmp = _compare_fused(4, False, True, seed=3, words=(41, -7))
    fused_err = fused_cmp[2]
    cmp_bound_ms, cmp_bound_by = _fused_bound_ms(fused_cmp[3], CHAINS, N, 4, False)
    for tuning_cmp in (_compare_fused(4, True, False, seed=4, words=(43, 11)),
                       _compare_fused(4, True, True, seed=5, words=(47, 13))):
        fused_err = max(fused_err, tuning_cmp[2])
    # 2d. the HMC trajectory kernel, diag metric
    hmc_err, _ = _compare_hmc(cg, _hmc_inputs(cg, np.linalg.cholesky(cg.cov), CHAINS, 0.2, 6),
                              (61, -67), need=0.99)
    _compare_hmc(sn, _hmc_inputs(sn, np.eye(4), CHAINS, 0.5, 7), (71, 73), need=1.0)
    # 2e. the fused HMC kernel: a draw chunk, a tune chunk with the step size
    # held, and a tune chunk as the HMC adapt_full path runs it
    fh_cmp = _compare_fused(4, False, True, seed=8, words=(53, -11), step="hmc")
    fh_err = fh_cmp[2]
    fh_bound_ms, fh_bound_by = _fused_hmc_bound_ms(fh_cmp[3], CHAINS, N, 4, False)
    for tuning_cmp in (_compare_fused(4, True, False, seed=9, words=(59, 17), step="hmc"),
                       _compare_fused(4, True, True, seed=10, words=(67, 19), step="hmc")):
        fh_err = max(fh_err, tuning_cmp[2])
    # 2f-2g. the per-draw kernels with the eight-schools body, 1024 chains
    es = EightSchools()
    es_exact = es.exact_moments()
    es_args = _posterior_inputs(es, CHAINS, 0.3, seed=11)
    es_traj_err, es_plain_ms = _compare("eight_schools", es, es_args, (83, -89), need=0.99,
                                        share=PLAIN_SHARE)
    es_hargs = _hmc_inputs(es, None, CHAINS, 0.25, 12)
    es_hmc_err, es_hmc_plain_ms = _compare_hmc(es, es_hargs, (97, 101), need=0.99, scaled=True)
    # 2h-2i. the fused kernels' diag branch, bodies 1 and 2, 1024 chains: a
    # 1-draw draw chunk, and a 2-draw tune chunk with the Welford steps (a
    # window swap at draw 1) and dual averaging on; the plain version steps
    # each block to its deepest chain's tree (about 70 leaves a chain-draw
    # for the 100-d body at the path's depth of 10), so the chunks are
    # short, to keep the script in its time
    diag_cmp = {}
    for step in ("nuts", "hmc"):
        for mname, model, T in (("correlated_gaussian", cg, 2), ("eight_schools", es, 2)):
            draw = _compare_fused(T // 2, False, True, 13, (103, -7), step, model, "diag")
            tune = _compare_fused(T, True, True, 14, (107, 11), step, model, "diag")
            diag_cmp[step, mname] = (draw, max(draw[2], tune[2]), T // 2)
    # 2j. the batched model kernels, rows 6 and 5, at the paths' widths
    lg_row = _compare_model_kernel("logistic", CHAINS, LG_N, LG_ROWS, seed=15)
    qf_row = _compare_model_kernel("quadform", CHAINS, N, seed=16)
    # 2k. the per-draw NUTS kernel with the logistic body, 1024 chains
    lg = LogisticRegression()
    lg_args = _posterior_inputs(lg, CHAINS, 0.25, 17)
    lg_traj_err, lg_plain_ms = _compare("logistic", lg, lg_args, (109, -113), need=0.99,
                                        share=PLAIN_SHARE)
    # 2l. the logistic body in the fused NUTS, the HMC and the fused HMC
    # kernels (on no path of this script), 256 chains, a 2-draw draw chunk
    lg_fused = {step: _compare_fused(2, False, True, 18, (113, 7), step, lg, "diag", chains=256)
                for step in ("nuts", "hmc")}
    lg_hargs = _hmc_inputs(lg, None, 256, 0.25, 20)
    lg_hmc_err, lg_hmc_plain_ms = _compare_hmc(lg, lg_hargs, (131, 137), need=0.99,
                                               scaled=True)
    # 2m. the trajectory kernel's low-rank branch (body 4 at 1024 chains,
    # body 1, on no cell, at 64), the spiked body (4) in the kDiag
    # trajectory kernel and in the HMC kernel (256 chains)
    sg = SpikedGaussian(N)
    lr_args = _lowrank_inputs(sg, CHAINS, 0.5, seed=23)
    lr_err, lr_plain_ms = _compare("spiked_gaussian", sg, lr_args[0], (139, -149), need=0.99,
                                   metric="lowrank", fac=lr_args[1], share=PLAIN_SHARE)
    cg_args, cg_fac = _lowrank_inputs(cg, 64, 0.5, seed=24)
    _compare("correlated_gaussian", cg, cg_args, (151, 157), need=0.99, metric="lowrank",
             fac=cg_fac, share=PLAIN_SHARE)
    sg_args = _posterior_inputs(sg, 256, 0.1, seed=25)
    sg_err, sg_plain_ms = _compare("spiked_gaussian", sg, sg_args, (163, 167), need=0.99,
                                   share=PLAIN_SHARE)
    sg_hargs = _hmc_inputs(sg, None, 256, 0.1, 26)
    sg_hmc_err, sg_hmc_plain_ms = _compare_hmc(sg, sg_hargs, (173, 179), need=0.99)
    # 2n. the fused kernels' low-rank branch with body 4, 256 chains: a
    # 2-draw draw chunk, and a 2-draw tune chunk with the per-chain Welford
    # steps across a window swap (at draw 1) and dual averaging on
    lr_fused = {}
    for step in ("nuts", "hmc"):
        draw = _compare_fused(2, False, True, 27, (181, 7), step, sg, "lowrank", chains=256)
        tune = _compare_fused(2, True, True, 28, (191, 11), step, sg, "lowrank", chains=256)
        lr_fused[step] = (draw, max(draw[2], tune[2]))
    # the fused NUTS kernel's kDiag instance with body 4 (the block
    # transition; on no cell), 256 chains: a 2-draw draw chunk at 2m's
    # positions and a 2-draw tune chunk with the Welford steps (the step
    # held), at 2m's step of 0.1 (at the fused checks' 0.3, or with dual
    # averaging moving it, 50-80% of these trees diverge, and fused_check
    # holds body 4's energies unscaled)
    sg_step = float(np.log(0.1))
    sg_draw = _compare_fused(2, False, True, 25, (229, 7), "nuts", sg, "diag", chains=256,
                             log_step=sg_step)
    sg_tune = _compare_fused(2, True, False, 30, (233, 11), "nuts", sg, "diag", chains=256,
                             log_step=sg_step)
    sg_fused = (sg_draw, max(sg_draw[2], sg_tune[2]))
    # 2o-2r. the funnel body (5) in the four kernels, the probe matrix, the
    # generated body in the per-draw NUTS kernel
    fa_chk = _funnel_auto_checks(NealsFunnel(10), hr, t_start)
    # 2s. the fused-kernel capability probes
    probe_rows = _fused_probe_checks(t_start)
    _line(phase="kernel_checks", elapsed_s=f"{time.perf_counter() - t_start:.1f}")

    # --- 3. the main path -------------------------------------------------------
    reset_counts()
    report = {}
    trace, stats, state = sample(cg.logp_grad, model_ndim=N, chains=CHAINS, tune=TUNE,
                                 draws=DRAWS, random_seed=42, perf_report=report,
                                 return_final_state=True, progressbar=False)
    launches = trajectory.launches
    if (report["kernel_launches"] != {"nuts_trajectory": TUNE + DRAWS, "fused_nuts": 0}
            or launches != TUNE + DRAWS or fused_nuts.launches != 0):
        raise RuntimeError(f"main path launched the kernel {launches} times, "
                           f"expected {TUNE + DRAWS}")
    _quality(cg, trace, stats, report["sample_seconds"], report, "main_path", smi,
             {"kernel_launches": launches})

    # 3b. init="adapt_full": pooled dense adaptation on the fused kernel
    reset_counts()
    report_f = {}
    trace_f, stats_f, state_f = sample(cg.logp_grad, model_ndim=N, chains=CHAINS, tune=TUNE,
                                       draws=DRAWS, random_seed=42, init="adapt_full",
                                       perf_report=report_f, return_final_state=True,
                                       progressbar=False)
    fused_launches, per_draw_launches = fused_nuts.launches, trajectory.launches
    # tune chunks 10, 10, 30, 50, then 100 four times; draw chunks 4 x 250
    if (report_f["engine"] != "fused_dense_pooled" or fused_launches != 12
            or per_draw_launches != 0
            or report_f["kernel_launches"] != {"nuts_trajectory": 0, "fused_nuts": 12}):
        raise RuntimeError(f"adapt_full ran engine {report_f['engine']} with "
                           f"{fused_launches} fused and {per_draw_launches} per-draw "
                           f"launches, expected fused_dense_pooled, 12 and 0")
    draw_depth = float(stats_f["depth"].mean())
    line_f = _quality(cg, trace_f, stats_f, report_f["sample_seconds"], report_f,
                      "adapt_full_fused", smi,
                      {"kernel_launches": report_f["kernel_launches"]})
    if draw_depth > 4.0:
        raise RuntimeError(f"adapt_full: draw-phase mean tree depth {draw_depth} > 4")

    # 3c. the same on the per-draw engine, the trajectory kernel's dense branch
    reset_counts()
    report_d = {}
    trace_d, stats_d, state_d = sample(cg.logp_grad, model_ndim=N, chains=CHAINS, tune=TUNE,
                                       draws=DRAWS, random_seed=42, init="adapt_full",
                                       fuse_draws=False, perf_report=report_d,
                                       return_final_state=True, progressbar=False)
    dense_launches = trajectory.launches
    if (report_d["engine"] != "per_draw_dense_pooled" or dense_launches != TUNE + DRAWS
            or fused_nuts.launches != 0):
        raise RuntimeError(f"adapt_full, fuse_draws=False ran engine {report_d['engine']} "
                           f"with {dense_launches} trajectory and {fused_nuts.launches} "
                           f"fused launches")
    line_d = _quality(cg, trace_d, stats_d, report_d["sample_seconds"], report_d,
                      "adapt_full_per_draw", smi,
                      {"kernel_launches": report_d["kernel_launches"]})
    _line(phase="dense_engines", fused_sample_seconds=line_f["sample_seconds"],
          per_draw_sample_seconds=line_d["sample_seconds"],
          fused_min_bulk_ess_per_s=line_f["min_bulk_ess_per_s"],
          per_draw_min_bulk_ess_per_s=line_d["min_bulk_ess_per_s"],
          elapsed_s=f"{time.perf_counter() - t_start:.1f}")

    # 3d. HamiltonianMC: jitter+adapt_diag on the HMC trajectory kernel
    reset_counts()
    report_h = {}
    trace_h, stats_h, state_h = sample(cg.logp_grad, model_ndim=N, chains=CHAINS, tune=TUNE,
                                       draws=DRAWS, random_seed=42,
                                       step=HamiltonianMC(model_ndim=N), perf_report=report_h,
                                       return_final_state=True, progressbar=False)
    hmc_launches = hmc_trajectory.launches
    want = {"trajectory": 0, "fused_nuts": 0, "hmc_trajectory": TUNE + DRAWS, "fused_hmc": 0}
    if (report_h["engine"] != "per_draw_diag" or counts() != want
            or report_h["kernel_launches"] != {"hmc_trajectory": TUNE + DRAWS, "fused_hmc": 0}):
        raise RuntimeError(f"the HMC path ran engine {report_h['engine']} with launches "
                           f"{counts()}, expected per_draw_diag and {want}")
    line_h = _quality(cg, trace_h, stats_h, report_h["sample_seconds"], report_h,
                      "hmc_path", smi, {"kernel_launches": report_h["kernel_launches"]})

    # 3e. HamiltonianMC with init="adapt_full": the fused HMC kernel
    reset_counts()
    report_hf = {}
    trace_hf, stats_hf, state_hf = sample(cg.logp_grad, model_ndim=N, chains=CHAINS,
                                          tune=TUNE, draws=DRAWS, random_seed=42,
                                          init="adapt_full", step=HamiltonianMC(model_ndim=N),
                                          perf_report=report_hf, return_final_state=True,
                                          progressbar=False)
    fh_launches = fused_hmc.launches
    want = {"trajectory": 0, "fused_nuts": 0, "hmc_trajectory": 0, "fused_hmc": 12}
    if (report_hf["engine"] != "fused_dense_pooled" or counts() != want
            or report_hf["kernel_launches"] != {"hmc_trajectory": 0, "fused_hmc": 12}):
        raise RuntimeError(f"the HMC adapt_full path ran engine {report_hf['engine']} with "
                           f"launches {counts()}, expected fused_dense_pooled and {want}")
    line_hf = _quality(cg, trace_hf, stats_hf, report_hf["sample_seconds"], report_hf,
                       "hmc_adapt_full_fused", smi,
                       {"kernel_launches": report_hf["kernel_launches"]})
    # the pooled dense metric was learned: a larger step than the diag path's
    if line_hf["step_size"] <= line_h["step_size"]:
        raise RuntimeError(f"HMC adapt_full: final step size {line_hf['step_size']} is not "
                           f"larger than the diag path's {line_h['step_size']}")

    # 3f. the same with fuse_draws=False: the tensor-op trajectory
    # (run_hmc_trajectory), timed beside 3e for the election
    reset_counts()
    report_hd = {}
    trace_hd, stats_hd = sample(cg.logp_grad, model_ndim=N, chains=CHAINS, tune=TUNE,
                                draws=DRAWS, random_seed=42, init="adapt_full",
                                step=HamiltonianMC(model_ndim=N), fuse_draws=False,
                                perf_report=report_hd, progressbar=False)
    if (report_hd["engine"] != "per_draw_dense_pooled" or report_hd["trajectory"] != "tensor"
            or any(counts().values())):
        raise RuntimeError(f"HMC adapt_full, fuse_draws=False ran engine "
                           f"{report_hd['engine']} ({report_hd['trajectory']}) with launches "
                           f"{counts()}")
    line_hd = _quality(cg, trace_hd, stats_hd, report_hd["sample_seconds"], report_hd,
                       "hmc_adapt_full_per_draw", smi, {"trajectory": "tensor"})
    _line(phase="hmc_dense_engines", fused_sample_seconds=line_hf["sample_seconds"],
          per_draw_sample_seconds=line_hd["sample_seconds"],
          fused_min_bulk_ess_per_s=line_hf["min_bulk_ess_per_s"],
          per_draw_min_bulk_ess_per_s=line_hd["min_bulk_ess_per_s"],
          elapsed_s=f"{time.perf_counter() - t_start:.1f}")

    # 3g-3j. eight schools at 10,240 chains, NUTS and HMC: the fused diag
    # engine, and the fuse_draws=False twin on the per-draw kernels
    es_lines, es_states = {}, {}
    for step, div_limit in (("nuts", 0.02), ("hmc", 0.01)):
        fused_op, per_draw_op = ((fused_nuts, trajectory) if step == "nuts"
                                 else (fused_hmc, hmc_trajectory))
        n_chunks = -(-ES_TUNE // 250) - (-ES_DRAWS // 250)
        for fuse, engine, launches_want in ((None, "fused_diag", {fused_op.__name__: n_chunks}),
                                            (False, "per_draw_diag",
                                             {per_draw_op.__name__: ES_TUNE + ES_DRAWS})):
            reset_counts()
            rep = {}
            es_step = (HamiltonianMC(model_ndim=10, target_accept=ES_TARGET) if step == "hmc"
                       else NUTS(model_ndim=10, target_accept=ES_TARGET))
            tr, st, fs = sample(es.logp_grad, model_ndim=10, chains=ES_CHAINS, tune=ES_TUNE,
                                draws=ES_DRAWS, random_seed=42, step=es_step, fuse_draws=fuse,
                                perf_report=rep, return_final_state=True, progressbar=False,
                                compute_convergence_checks=False)
            got = {k: v for k, v in counts().items() if v}
            if rep["engine"] != engine or got != launches_want:
                raise RuntimeError(f"eight schools {step}, fuse_draws={fuse}: engine "
                                   f"{rep['engine']}, launches {got}; expected {engine}, "
                                   f"{launches_want}")
            es_lines[step, engine] = _es_quality(es, es_exact, tr, st, rep,
                                                 f"eight_schools_{step}_{engine}", smi,
                                                 div_limit, {"kernel_launches": got})
            es_states[step, engine] = fs
        _line(phase=f"eight_schools_{step}_engines",
              fused_sample_seconds=es_lines[step, "fused_diag"]["sample_seconds"],
              per_draw_sample_seconds=es_lines[step, "per_draw_diag"]["sample_seconds"],
              elapsed_s=f"{time.perf_counter() - t_start:.1f}")

    # 3k. the 100-d NUTS main path with fuse_draws=True: the fused kernel's
    # diag branch with the correlated body (2 tune chunks, 4 draw chunks)
    reset_counts()
    report_fd = {}
    trace_fd, stats_fd, state_fd = sample(cg.logp_grad, model_ndim=N, chains=CHAINS, tune=TUNE,
                                          draws=DRAWS, random_seed=42, fuse_draws=True,
                                          perf_report=report_fd, return_final_state=True,
                                          progressbar=False)
    fd_launches = fused_nuts.launches
    if (report_fd["engine"] != "fused_diag" or trajectory.launches != 0
            or fd_launches != -(-TUNE // 250) - (-DRAWS // 250)):
        raise RuntimeError(f"fuse_draws=True ran engine {report_fd['engine']} with "
                           f"{fd_launches} fused and {trajectory.launches} per-draw launches")
    line_fd = _quality(cg, trace_fd, stats_fd, report_fd["sample_seconds"], report_fd,
                       "main_path_fused_diag", smi,
                       {"kernel_launches": report_fd["kernel_launches"]})
    _line(phase="diag_engines", fused_sample_seconds=line_fd["sample_seconds"],
          per_draw_sample_seconds=report["sample_seconds"],
          elapsed_s=f"{time.perf_counter() - t_start:.1f}")

    # 3o-3r. the low-rank cells on the spiked Gaussian: L1-L3 and L0, the
    # diag contrast
    lr = _lowrank_cells(smi, sg, reset_counts, counts, t_start)

    # 3l-3n. logistic regression on the tree (path A) and on the trajectory
    # kernel (path B); per-chain dense adaptation on the tree (T2)
    tp = _tree_paths(smi, lg, reset_counts, counts, model_ops, t_start)

    # 3s-3u. the funnel cells F1, F2 and the generated-body cell H1
    fa_cells = _funnel_auto_cells(smi, reset_counts, counts, t_start)

    # 3v-3y. checkpoint/resume, device_trace, linear regression and
    # stochastic volatility
    sf = _surface_cells(smi, cg, lin, sv, reset_counts, counts, t_start)
    sf.update(lin_model=lin, sv_model=sv)

    # --- 4. the kernel's time at the main path's final state -------------------
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    pot = state.potential
    step_size = torch.exp(state.da.log_bar)
    targs = (state.q, pot.sample_momentum(gen), state.q_grad, state.logp, step_size,
             torch.full((CHAINS,), DEPTH, dtype=torch.int32, device=DEVICE), pot.var)
    kw = dict(spec=cg.trajectory_spec(), max_treedepth=DEPTH, Emax=1000.0,
              chain_block=CHAIN_BLOCK)
    out = trajectory(*targs, (3, 8), **kw)
    leaves = int(out["n_leaves"].sum())
    events_ms = _cuda_time_ms(lambda: trajectory(*targs, (3, 8), **kw), reps=20, warmup=3)
    kernel_ms, ms_src = _device_ms(lambda: trajectory(*targs, (3, 8), **kw), "nuts_trajectory",
                                   20, events_ms)
    # plain_ms is phase 2's launch of the plain version (the same shapes, 71
    # against 70.7 leaves a chain): a second one here took 25-38 s
    bound_ms, bound_by = _bound_ms(leaves, CHAINS, N)
    _line(phase="timing", kernel_ms=f"{kernel_ms:.4f}", ms_source=ms_src,
          events_ms=f"{events_ms:.4f}", plain_ms=f"{plain_ms:.1f}",
          bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
          mean_leaves=f"{leaves / CHAINS:.2f}", elapsed_s=f"{time.perf_counter() - t_start:.1f}")
    _breakdown(cg, state, gen)

    # 4b. the fused kernel at 3b's final state: one 250-draw chunk
    cfg = NUTSConfig()
    pot_f = state_f.potential
    cov = pot_f.cov[0].contiguous()
    linv = torch.linalg.solve_triangular(pot_f.chol[0], torch.eye(N, device=DEVICE),
                                         upper=False)
    da = state_f.da
    fargs = (state_f.q, state_f.q_grad, state_f.logp, state_f.iter_count.float(),
             da.log_step, da.log_bar, da.hbar, da.count.float(), da.mu, cov, linv)
    fkw = dict(spec=cg.trajectory_spec(), T=250, tuning=False, config=cfg,
               chain_block=CHAIN_BLOCK)
    fout = fused_nuts(*fargs, (5, 9), **fkw)
    f_leaves = int(fout["n_leaves"].sum())
    f_ms = _cuda_time_ms(lambda: fused_nuts(*fargs, (5, 9), **fkw), reps=3, warmup=0)
    f_bound_ms, f_bound_by = _fused_bound_ms(f_leaves, CHAINS, N, 250, False)
    _line(phase="fused_timing", chunk_draws=250, kernel_ms=f"{f_ms:.4f}",
          ms_per_draw=f"{f_ms / 250:.5f}", bound_ms=f"{f_bound_ms:.4f}",
          bound_by=f_bound_by, mean_leaves_per_draw=f"{f_leaves / CHAINS / 250:.3f}",
          max_depth=int(fout["depth"].max()),
          plain_ms_4_draws=f"{fused_cmp[1]:.1f}", kernel_ms_4_draws=f"{fused_cmp[0]:.4f}")
    _fused_breakdown(cg, state_f, 250, TUNE + DRAWS)
    _fused_path_breakdown(cg)

    # the dense trajectory kernel at 3c's final state
    pot_d = state_d.potential
    dargs = (state_d.q, pot_d.sample_momentum(gen), state_d.q_grad, state_d.logp,
             torch.exp(state_d.da.log_bar),
             torch.full((CHAINS,), DEPTH, dtype=torch.int32, device=DEVICE),
             pot_d.cov[0].contiguous())
    dkw = dict(kw, metric="dense")
    dout = trajectory(*dargs, (3, 8), **dkw)
    d_leaves = int(dout["n_leaves"].sum())
    d_events_ms = _cuda_time_ms(lambda: trajectory(*dargs, (3, 8), **dkw), reps=20, warmup=3)
    d_ms, d_src = _device_ms(lambda: trajectory(*dargs, (3, 8), **dkw), "nuts_trajectory", 20,
                             d_events_ms)
    d_pargs, _ = _plain_inputs(dargs, {}, _plain_chains(CHAINS, PLAIN_SHARE), CHAINS,
                               shared=(6,))
    d_plain_ms = _cuda_time_ms(lambda: trajectory_plain(*d_pargs, (3, 8), **dkw), reps=1,
                               warmup=0)
    d_bound_ms, d_bound_by = _bound_ms(d_leaves, CHAINS, N, "dense")
    _line(phase="dense_timing", kernel_ms=f"{d_ms:.4f}", ms_source=d_src,
          events_ms=f"{d_events_ms:.4f}", plain_ms=f"{d_plain_ms:.1f}",
          plain_chains=_plain_chains(CHAINS, PLAIN_SHARE),
          bound_ms=f"{d_bound_ms:.4f}", bound_by=d_bound_by,
          mean_leaves=f"{d_leaves / CHAINS:.2f}", elapsed_s=f"{time.perf_counter() - t_start:.1f}")

    # 4c. the HMC trajectory kernel at 3d's final state, step counts drawn
    # as the sampler draws them
    pot_h = state_h.potential
    eps_h = torch.exp(state_h.da.log_bar)
    path = torch.rand(CHAINS, generator=gen, device=DEVICE) * 2.0
    hargs = (state_h.q, pot_h.sample_momentum(gen), state_h.q_grad, state_h.logp, eps_h,
             torch.clamp((path / eps_h).to(torch.int32), 1, 1024), pot_h.var.contiguous())
    hkw = dict(spec=cg.trajectory_spec(), Emax=1000.0)
    h_steps = int(hargs[5].sum())
    h_events_ms = _cuda_time_ms(lambda: hmc_trajectory(*hargs, (3, 8), **hkw), reps=50,
                                warmup=3)
    h_ms, h_src = _device_ms(lambda: hmc_trajectory(*hargs, (3, 8), **hkw), "hmc_trajectory",
                             50, h_events_ms)
    h_plain_ms = _cuda_time_ms(lambda: hmc_trajectory_plain(*hargs, (3, 8), **hkw), reps=1,
                               warmup=0)
    h_bound_ms, h_bound_by = _hmc_bound_ms(h_steps, CHAINS, N)
    h_bps = _build.last_blocks_per_sm("hmc_trajectory")
    _line(phase="hmc_timing", kernel_ms=f"{h_ms:.4f}", ms_source=h_src, blocks_per_sm=h_bps,
          events_ms=f"{h_events_ms:.4f}", plain_ms=f"{h_plain_ms:.2f}",
          bound_ms=f"{h_bound_ms:.5f}", bound_by=h_bound_by,
          mean_n_steps=f"{h_steps / CHAINS:.2f}", max_n_steps=int(hargs[5].max()),
          elapsed_s=f"{time.perf_counter() - t_start:.1f}")
    _breakdown(cg, state_h, gen, step="hmc")

    # 4d. the fused HMC kernel at 3e's final state: one 250-draw chunk
    pot_hf = state_hf.potential
    cov_h = pot_hf.cov[0].contiguous()
    linv_h = torch.linalg.solve_triangular(pot_hf.chol[0], torch.eye(N, device=DEVICE),
                                           upper=False)
    da_h = state_hf.da
    fhargs = (state_hf.q, state_hf.q_grad, state_hf.logp, state_hf.iter_count.float(),
              da_h.log_step, da_h.log_bar, da_h.hbar, da_h.count.float(), da_h.mu, cov_h, linv_h)
    fhkw = dict(spec=cg.trajectory_spec(), T=250, tuning=False, config=HMCConfig(),
                chain_block=CHAIN_BLOCK)
    fhout = fused_hmc(*fhargs, (5, 9), **fhkw)
    fh_steps = int(fhout["n_steps"].sum())
    fh_ms = _cuda_time_ms(lambda: fused_hmc(*fhargs, (5, 9), **fhkw), reps=3, warmup=0)
    fh_chunk_bound_ms, fh_chunk_bound_by = _fused_hmc_bound_ms(fh_steps, CHAINS, N, 250, False)
    fh_bps = _build.last_blocks_per_sm("fused_hmc")
    _line(phase="fused_hmc_timing", chunk_draws=250, kernel_ms=f"{fh_ms:.4f}",
          blocks_per_sm=fh_bps,
          ms_per_draw=f"{fh_ms / 250:.5f}", bound_ms=f"{fh_chunk_bound_ms:.4f}",
          bound_by=fh_chunk_bound_by, mean_n_steps=f"{fh_steps / CHAINS / 250:.3f}",
          max_n_steps=int(fhout["n_steps"].max()),
          plain_ms_4_draws=f"{fh_cmp[1]:.1f}", kernel_ms_4_draws=f"{fh_cmp[0]:.4f}")
    _fused_path_breakdown(cg, step="hmc")

    # 4e. the eight-schools kernels: the per-draw kernels at 2f-2g's inputs
    # (1024 chains) and at the 10,240-chain twins' final states, the fused
    # kDiag instances per 250-draw chunk at the fused paths' final states;
    # where the eight-schools calls spend their time; the fused diag call of
    # 3k and where the 100-d fused diag call spends its time
    es_kw = dict(spec=es.trajectory_spec(), max_treedepth=DEPTH, Emax=1000.0,
                 chain_block=CHAIN_BLOCK)
    es_leaves = int(trajectory(*es_args, (83, -89), **es_kw)["n_leaves"].sum())
    es_ev = _cuda_time_ms(lambda: trajectory(*es_args, (83, -89), **es_kw), reps=20, warmup=3)
    es_ms, es_src = _device_ms(lambda: trajectory(*es_args, (83, -89), **es_kw),
                               "nuts_trajectory", 20, es_ev)
    es_bound = _bound_ms(es_leaves, CHAINS, 10, body="eight_schools")
    es_hkw = dict(spec=es.trajectory_spec(), Emax=1000.0)
    es_h_ev = _cuda_time_ms(lambda: hmc_trajectory(*es_hargs, (97, 101), **es_hkw), reps=20,
                            warmup=3)
    es_h_ms, es_h_src = _device_ms(lambda: hmc_trajectory(*es_hargs, (97, 101), **es_hkw),
                                   "hmc_trajectory", 20, es_h_ev)
    es_h_bound = _hmc_bound_ms(int(es_hargs[5].sum()), CHAINS, 10, body="eight_schools")
    _line(phase="es_check_input_timing", nuts_trajectory_ms=es_ms, nuts_ms_source=es_src,
          nuts_bound_ms=es_bound[0], mean_leaves=es_leaves / CHAINS,
          hmc_trajectory_ms=es_h_ms, hmc_ms_source=es_h_src, hmc_bound_ms=es_h_bound[0],
          mean_n_steps=float(es_hargs[5].float().mean()))
    es_timing = {}
    for step in ("nuts", "hmc"):
        es_timing[step] = _es_kernel_timing(es, es_states[step, "fused_diag"],
                                            es_states[step, "per_draw_diag"], step, gen)
        es_step = (HamiltonianMC(model_ndim=10, target_accept=ES_TARGET) if step == "hmc"
                   else NUTS(model_ndim=10, target_accept=ES_TARGET))
        _fused_path_breakdown(es, step, dict(model_ndim=10, chains=ES_CHAINS, tune=ES_TUNE,
                                             draws=ES_DRAWS, step=es_step),
                              draw_chunks=2, label="_eight_schools")
        _breakdown(es, es_states[step, "per_draw_diag"], gen, step=step, label="_eight_schools")
    # the kDiag instance with the correlated body: one 250-draw draw chunk
    # at 3k's final state
    pot_fd, da_fd = state_fd.potential, state_fd.da
    fdargs = (state_fd.q, state_fd.q_grad, state_fd.logp, state_fd.iter_count.float(),
              da_fd.log_step, da_fd.log_bar, da_fd.hbar, da_fd.count.float(), da_fd.mu,
              pot_fd.var.contiguous(), None)
    fdkw = dict(spec=cg.trajectory_spec(), T=250, tuning=False, config=NUTSConfig(),
                metric="diag", chain_block=CHAIN_BLOCK)
    fd_leaves = int(fused_nuts(*fdargs, (5, 9), **fdkw)["n_leaves"].sum())
    fd_ev = _cuda_time_ms(lambda: fused_nuts(*fdargs, (5, 9), **fdkw), reps=3, warmup=0)
    fd_ms, fd_src = _device_ms(lambda: fused_nuts(*fdargs, (5, 9), **fdkw), "fused_nuts", 3,
                               fd_ev)
    fd_bound = _fused_diag_bound_ms(fd_leaves, CHAINS, N, 250, False, "correlated_gaussian")
    _line(phase="fused_diag_timing", chunk_draws=250, kernel_ms=f"{fd_ms:.4f}",
          ms_source=fd_src, events_ms=f"{fd_ev:.4f}", bound_ms=f"{fd_bound[0]:.4f}",
          bound_by=fd_bound[1], mean_leaves_per_draw=f"{fd_leaves / CHAINS / 250:.3f}")
    _fused_path_breakdown(cg, "nuts", dict(model_ndim=N, chains=CHAINS, tune=TUNE,
                                           draws=DRAWS, fuse_draws=True),
                          draw_chunks=4, label="_fused_diag")
    _line(phase="es_timing_done", elapsed_s=f"{time.perf_counter() - t_start:.1f}")

    # 4f. the logistic paths' breakdowns and kernel times
    lt = _logistic_timing(lg, tp, lg_args, lg_hargs, gen, t_start)

    # 4g. the low-rank kernels and the spiked body at the L cells' final
    # states, and where L1 and L2 spend their time
    lr_rows = _lowrank_timing(sg, lr, lr_args, (lr_err, lr_plain_ms), sg_args,
                              (sg_err, sg_plain_ms), sg_hargs, (sg_hmc_err, sg_hmc_plain_ms),
                              lr_fused, gen, t_start)

    # 4h. the funnel's and the generated body's kernels at F1's and H1's
    # final states, the tree on H1's model, the probe kernel
    fa_rows = _funnel_auto_timing(fa_chk, fa_cells, gen, t_start)

    # 4i. the two new generated bodies at their cells' final states
    sf_rows = _surface_rows(sf, logs, gen, t_start)

    traj_src = "littlemcmc_torch/ops/csrc/nuts_trajectory.cu"
    traj_tpu = "littlemcmc_tpu/ops/nuts_trajectory_pallas.py:1023"
    fn_src, fn_tpu = ("littlemcmc_torch/ops/csrc/fused_nuts.cu",
                      "littlemcmc_tpu/ops/fused_nuts_pallas.py:978")
    fh_src, fh_tpu = ("littlemcmc_torch/ops/csrc/fused_hmc.cu",
                      "littlemcmc_tpu/ops/fused_hmc_pallas.py:511")

    def diag_row(step, mname, n, launches_main, main_ms=None, main_bound=None):
        """A fused kDiag instance: ms, plain_ms and bound_ms at 2h-2i's
        draw-chunk input (1024 chains, ``draws``); chunk_*: one 250-draw launch
        at the main path's final state."""
        (k_ms, p_ms, _, work, ev_ms), err, T = diag_cmp[step, mname]
        bound = _fused_diag_bound_ms(work, CHAINS, n, T, False, mname, step)
        row = {"name": f"fused_{step}", "metric": "diag", "body": mname, "route": "cuda",
               "source": fn_src if step == "nuts" else fh_src,
               "replaces": fn_tpu if step == "nuts" else fh_tpu,
               "launches": launches_main, "max_abs_err": err, "ms": k_ms, "events_ms": ev_ms,
               "draws": T, "plain_ms": p_ms, "bound_ms": bound[0], "bound_by": bound[1],
               "library_ms": None}
        if main_ms is not None:
            row.update(chunk_draws=250, chunk_ms=main_ms, chunk_bound_ms=main_bound[0],
                       chunk_bound_by=main_bound[1])
        return row

    es_rows = [
        # ms, plain_ms, bound_ms: one launch at 2f's input (1024 chains);
        # main_*: one launch at the 10,240-chain twin's final state
        {"name": "nuts_trajectory", "metric": "diag", "body": "eight_schools",
         "route": "cuda", "source": traj_src, "replaces": traj_tpu,
         "launches": es_lines["nuts", "per_draw_diag"]["kernel_launches"]["trajectory"],
         "max_abs_err": es_traj_err, "ms": es_ms, "ms_source": es_src,
         "plain_ms": es_plain_ms, "bound_ms": es_bound[0], "bound_by": es_bound[1],
         "library_ms": None, "main_chains": ES_CHAINS,
         "main_ms": es_timing["nuts"]["per_draw_ms"],
         "main_bound_ms": es_timing["nuts"]["per_draw_bound_ms"],
         "blocks_per_sm": es_timing["nuts"]["per_draw_blocks_per_sm"]},
        {"name": "hmc_trajectory", "metric": "diag", "body": "eight_schools",
         "route": "cuda", "source": "littlemcmc_torch/ops/csrc/hmc_trajectory.cu",
         "replaces": "littlemcmc_tpu/ops/hmc_trajectory_pallas.py:273",
         "launches": es_lines["hmc", "per_draw_diag"]["kernel_launches"]["hmc_trajectory"],
         "max_abs_err": es_hmc_err, "ms": es_h_ms, "ms_source": es_h_src,
         "plain_ms": es_hmc_plain_ms, "bound_ms": es_h_bound[0], "bound_by": es_h_bound[1],
         "library_ms": None, "main_chains": ES_CHAINS,
         "main_ms": es_timing["hmc"]["per_draw_ms"],
         "main_bound_ms": es_timing["hmc"]["per_draw_bound_ms"]},
        diag_row("nuts", "correlated_gaussian", N, fd_launches, fd_ms, fd_bound),
        dict(diag_row("nuts", "eight_schools", 10,
                      es_lines["nuts", "fused_diag"]["kernel_launches"]["fused_nuts"],
                      es_timing["nuts"]["fused_ms"],
                      (es_timing["nuts"]["fused_bound_ms"], es_timing["nuts"]["fused_bound_by"])),
             blocks_per_sm=es_timing["nuts"]["fused_blocks_per_sm"]),
        dict(diag_row("hmc", "eight_schools", 10,
                      es_lines["hmc", "fused_diag"]["kernel_launches"]["fused_hmc"],
                      es_timing["hmc"]["fused_ms"],
                      (es_timing["hmc"]["fused_bound_ms"], es_timing["hmc"]["fused_bound_by"])),
             blocks_per_sm=es_timing["hmc"]["fused_blocks_per_sm"]),
    ]
    def lg_fused_row(step):
        """The logistic body's fused kDiag instance: one 2-draw draw chunk of
        256 chains at 2l's input."""
        k_ms, p_ms, err, work, ev_ms = lg_fused[step]
        bound = _fused_diag_bound_ms(work, 256, LG_N, 2, False, "logistic", step, LG_ROWS)
        return {"name": f"fused_{step}", "metric": "diag", "body": "logistic", "route": "cuda",
                "source": fn_src if step == "nuts" else fh_src,
                "replaces": fn_tpu if step == "nuts" else fh_tpu, "launches": 0,
                "max_abs_err": err, "ms": k_ms, "events_ms": ev_ms, "chains": 256, "draws": 2,
                "plain_ms": p_ms, "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": None}

    def sg_fused_row():
        """The spiked body's fused kDiag instance: one 2-draw draw chunk of
        256 chains at 2m's positions."""
        (k_ms, p_ms, _, work, ev_ms), err = sg_fused
        bound = _fused_diag_bound_ms(work, 256, N, 2, False, "spiked_gaussian", "nuts",
                                     sg.rank)
        return {"name": "fused_nuts", "metric": "diag", "body": "spiked_gaussian",
                "route": "cuda", "source": fn_src, "replaces": fn_tpu, "launches": 0,
                "max_abs_err": err, "ms": k_ms, "events_ms": ev_ms, "chains": 256, "draws": 2,
                "plain_ms": p_ms, "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": None}

    lg_rows = [
        # the per-draw kernel's logistic body, path (B): ms, plain_ms,
        # bound_ms and max_abs_err one launch at 2k's input (1024 chains);
        # main_*: one launch at path (B)'s final state
        {"name": "nuts_trajectory", "metric": "diag", "body": "logistic", "route": "cuda",
         "source": traj_src, "replaces": traj_tpu, "launches": tp["b_launches"],
         "max_abs_err": lg_traj_err, **lt["lg_row"], "plain_ms": lg_plain_ms,
         "library_ms": None},
        # rows 6 and 5 on paths (A) and T2, timed at 2j's inputs (ms: the
        # kernel's device time; library_ms: the library yardstick's)
        dict(lg_row, launches=tp["a_launches"]),
        dict(qf_row, launches=tp["t2_launches"]),
        lg_fused_row("nuts"),
        # the HMC kernel's logistic body at 2l's input, 256 chains
        {"name": "hmc_trajectory", "metric": "diag", "body": "logistic", "route": "cuda",
         "source": "littlemcmc_torch/ops/csrc/hmc_trajectory.cu",
         "replaces": "littlemcmc_tpu/ops/hmc_trajectory_pallas.py:273", "launches": 0,
         "max_abs_err": lg_hmc_err, "ms": lt["lh_ms"], "ms_source": lt["lh_src"],
         "events_ms": lt["lh_events"], "chains": 256, "plain_ms": lg_hmc_plain_ms,
         "bound_ms": lt["lh_bound"][0], "bound_by": lt["lh_bound"][1], "library_ms": None},
        lg_fused_row("hmc"),
    ]
    # the ptxas lines of the instances the block transition took over in
    # the last slices (bodies 2, 4 and 5 with the diagonal metric, body 1
    # with the dense metric, body 4 with the low-rank metric, which has no
    # warp instance), beside their warp-transition instances (blocks of
    # more than 8 chains)
    for name in ("nuts_trajectory", "fused_nuts"):
        moved = {}
        for entry, lines in _ptxas_entries(logs[name].read_text()).items():
            # <body, metric, block>, or the kernels' own block kernels
            for b, m, own in ((2, 0, f"{name}_es_block_kernel"),
                              (4, 0, "fused_nuts_block_kernel"),
                              (5, 0, "fused_nuts_block_kernel"),
                              (1, 1, f"{name}_dense_block_kernel"),
                              (4, 2, f"{name}_lowrank_block_kernel")):
                if f"ILi{b}ELi{m}ELb1E" in entry or f"{own}ILi{b}E" in entry:
                    moved[f"<{b},{m},block>"] = lines
                elif f"ILi{b}ELi{m}ELb0E" in entry:
                    moved[f"<{b},{m},warp>"] = lines
        print(json.dumps({"phase": "ptxas_block_instances", "library": name,
                          "instances": moved}), flush=True)
    # the HMC kernels' instances on the block HMC transition (body 1: per
    # draw with the diagonal metric, whose warp instance is not compiled;
    # fused with the dense metric) beside the fused one's warp instance
    # (blocks of more than 8 chains)
    for name in ("hmc_trajectory", "fused_hmc"):
        print(json.dumps({"phase": "ptxas_block_instances", "library": name,
                          "instances": _hmc_moved_instances(logs[name].read_text())}),
              flush=True)

    # no single PyTorch call computes a NUTS or an HMC transition:
    # library_ms is null. ms: the kernel's device time per launch
    # (_device_ms); events_ms: CUDA events around back-to-back calls of its
    # wrapper, which also count the card waiting for the host; transition:
    # which of nuts_transition.cuh's transitions a NUTS row's instance runs
    rows = [
        {"name": "nuts_trajectory", "metric": "diag", "route": "cuda", "source": traj_src,
         "replaces": traj_tpu, "launches": launches, "max_abs_err": max_abs_err,
         "ms": kernel_ms, "events_ms": events_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": None},
        {"name": "nuts_trajectory", "metric": "dense", "route": "cuda", "source": traj_src,
         "replaces": traj_tpu, "launches": dense_launches, "max_abs_err": dense_err,
         "ms": d_ms, "events_ms": d_events_ms, "plain_ms": d_plain_ms, "bound_ms": d_bound_ms,
         "bound_by": d_bound_by, "library_ms": None},
        # ms, plain_ms and bound_ms: one 4-draw launch of 1024 chains on
        # phase 2c's draw-chunk input; chunk_*: one 250-draw launch at
        # 3b's final state (the main path's draw chunk)
        {"name": "fused_nuts", "metric": "dense", "route": "cuda",
         "source": "littlemcmc_torch/ops/csrc/fused_nuts.cu",
         "replaces": "littlemcmc_tpu/ops/fused_nuts_pallas.py:978",
         "launches": fused_launches, "max_abs_err": fused_err, "ms": fused_cmp[0],
         "events_ms": fused_cmp[4], "draws": 4, "plain_ms": fused_cmp[1],
         "bound_ms": cmp_bound_ms,
         "bound_by": cmp_bound_by, "library_ms": None, "chunk_draws": 250,
         "chunk_ms": f_ms, "chunk_bound_ms": f_bound_ms, "chunk_bound_by": f_bound_by},
        # ms, plain_ms and bound_ms: one launch at 3d's final state
        {"name": "hmc_trajectory", "metric": "diag", "route": "cuda",
         "source": "littlemcmc_torch/ops/csrc/hmc_trajectory.cu",
         "replaces": "littlemcmc_tpu/ops/hmc_trajectory_pallas.py:273",
         "launches": hmc_launches, "max_abs_err": hmc_err, "ms": h_ms,
         "events_ms": h_events_ms, "plain_ms": h_plain_ms, "bound_ms": h_bound_ms,
         "bound_by": h_bound_by, "library_ms": None, "blocks_per_sm": h_bps},
        # as fused_nuts: one 4-draw launch on phase 2e's draw-chunk input;
        # chunk_*: one 250-draw launch at 3e's final state
        {"name": "fused_hmc", "metric": "dense", "route": "cuda",
         "source": "littlemcmc_torch/ops/csrc/fused_hmc.cu",
         "replaces": "littlemcmc_tpu/ops/fused_hmc_pallas.py:511",
         "launches": fh_launches, "max_abs_err": fh_err, "ms": fh_cmp[0],
         "events_ms": fh_cmp[4], "draws": 4, "plain_ms": fh_cmp[1], "bound_ms": fh_bound_ms,
         "bound_by": fh_bound_by,
         "library_ms": None, "chunk_draws": 250, "chunk_ms": fh_ms,
         "chunk_bound_ms": fh_chunk_bound_ms, "chunk_bound_by": fh_chunk_bound_by,
         "blocks_per_sm": fh_bps},
    ] + es_rows + lg_rows + lr_rows + [sg_fused_row()] + fa_rows + sf_rows + [
        # the fused probes: launches on F1's path (the fused engine's five)
        # and L1's (the low-rank one)
        dict(row, launches=(fa_cells["f1_probes"] if name != "thin_factor"
                            else lr["L1"][0]["probe_launches"])[name])
        for name, row in probe_rows.items()]
    for row in rows:
        if row["name"] == "hmc_trajectory":
            # the per-draw HMC kernel's transition: the block HMC transition
            # of csrc/hmc_transition.cuh, or a warp a chain
            block = runs_hmc_block_transition(row.get("body", "correlated_gaussian"),
                                              row["metric"], CHAIN_BLOCK, False)
            row["transition"] = "block" if block else "warp"
        if row["name"] == "fused_hmc":
            # the fused HMC kernel's: block, registers (row 4c), packed
            # (row 4b) or warp; every row's instance runs at n <= N
            row["transition"] = fused_hmc_transition(row.get("body", "correlated_gaussian"),
                                                     row["metric"], CHAIN_BLOCK, N)
        if row["name"] in ("nuts_trajectory", "fused_nuts"):
            block = runs_block_transition(row.get("body", "correlated_gaussian"),
                                          row["metric"], CHAIN_BLOCK)
            row["transition"] = "block" if block else "warp"
            # plain_ms: the plain version on the first of the row's chains
            # (PLAIN_SHARE)
            row.setdefault("plain_chains",
                           _plain_chains(row.get("chains", CHAINS), PLAIN_SHARE))
    print(json.dumps({"kernels": rows}), flush=True)
    _line(phase="done", elapsed_s=f"{time.perf_counter() - t_start:.1f}")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
