#!/usr/bin/env python3
"""Where the NUTS and HMC transitions' time goes on the card, section by
section.

    python3 scripts/torch_transition_clocks.py [ROOT] [--cases=CASE,...]

Builds the per-draw trajectory kernel (``nuts_trajectory.cu``), the
fused NUTS kernel (``fused_nuts.cu``) and the two HMC kernels
(``hmc_trajectory.cu``, ``fused_hmc.cu``) of the checkout at ROOT
(default: the one this script is in) a second time with
``-DLMC_TRANSITION_CLOCKS``, which compiles in the section clocks of
``csrc/nuts_transition.cuh`` and ``csrc/hmc_transition.cuh`` (the
package's own build never sets it), and runs their diag and dense
instances through the package's wrappers (NUTS: tree depth 10, chain
blocks of 8):

- the 100-d correlated Gaussian (body 1, rows 1 diag and 2b body 1), 1024
  chains, at ``chip_smoke.py``'s phase-2 input (stationary, step 0.2) and
  at the main path's final state;
- Neal's centred funnel (body 5, row 2a) at F1's final state and phase
  2p's draw-chunk input (fused), and at phase 2o's input (per draw);
- the 100-d spiked Gaussian (body 4, row 1 body 4) at L0's final state
  and phase 2m's input (per draw), and its fused instance in a 2-draw
  chunk of 256 chains at 2m's positions;
- the 100-d correlated Gaussian with the pooled dense metric (rows 2 and
  1 dense): the fused instance at ``adapt_full``'s final state (its
  covariance and inverse Cholesky factor) and in phase 2c's tune chunk as
  that cell runs it (``adapt_dense``, the step size adapting), the
  per-draw instance at phase 2b's input and at the per-draw twin's final
  state;
- the 100-d spiked Gaussian with the pooled low-rank metric (rows 2c and
  1 low-rank): the fused instance at L1's final state (its variances and
  factor block), the per-draw instance at L2's final state (its scales
  and factor block) and at phase 2m's low-rank input;
- eight schools (body 2, rows 2b body 2 and 1 body 2) at 10,240 chains:
  the fused instance at the final state of the NUTS ``fused_diag`` cell
  (``es_fused_final``), the per-draw instance at its ``fuse_draws=False``
  twin's (``es_per_draw_final``), and the per-draw instance at
  ``chip_smoke.py``'s phase-2f input (1024 chains, ``phase2f``);
- HMC on the 100-d correlated Gaussian (rows 3 and 4 dense): the per-draw
  kernel at the HMC main path's final state with step counts drawn as the
  sampler draws them (``hmc_final``) and at phase 2d's input
  (``hmc_phase2d``), the fused kernel's dense instance in a 250-draw
  chunk at HMC ``adapt_full``'s final state (``hmc_af_final``) and in
  phase 2e's tune chunk as that cell runs it (``hmc_af_tune``:
  ``adapt_dense``, the step size adapting);
- HMC's fused rows 4c and 4b: the low-rank instance on the 100-d spiked
  Gaussian in a 250-draw chunk at L3's final state (``hmc_l3_final``) and
  in a 4-draw tune chunk as L3 runs it (``hmc_l3_tune``: the per-chain
  Welford steps across a window swap, the step size adapting, the model's
  spikes as the factor), and the diag instance on eight schools at 10,240
  chains in a 250-draw chunk at the HMC ``fused_diag`` cell's final state
  (``hmc_es_final``) and in a 4-draw tune chunk as that cell runs it
  (``hmc_es_tune``).

A fused launch from a final state runs a 250-draw draw chunk. The final
states (main path, F1, L0, ``adapt_full`` fused and per draw, L1 and L2:
``sample()`` at 1024 chains, 500 + 1000, seed 42; the eight-schools cell
and its twin: 10,240 chains, 500 + 500, ``target_accept=0.95``, seed 42;
HMC's main path, ``adapt_full`` and L3: ``HamiltonianMC``, 1024 chains, 500 +
1000, seed 42; eight schools' HMC cell: as its NUTS cell) are sampled once with ROOT's package and kept in
``build/`` beside this script (``STATE_FILES``), so that every checkout
timed in one call sees the same states.

For each launch it prints one JSON line:

- ``ms`` (CUDA events, the instrumented build) and ``plain_build_ms`` (the
  package's own build, the same launch): the instrumentation's cost; for
  the HMC cases also ``device_ms``, the package build's device time a
  launch under ``torch.profiler``;
- ``blocks_per_sm``, the blocks of the package build's launch that fit
  on an SM at once (the CUDA runtime's occupancy at the launch's threads
  and dynamic shared memory, which the libraries record at each launch;
  null for a checkout from before that query), and ``waves``, the grid's
  blocks over that many on every SM;
- the blocks' start and end on the global timer and their SMs: the
  span, the blocks' busy times, and ``tail_share``, the share of SM-time
  between the first start and the last end in which the SMs that ran a
  block sat idle after their block had ended (``tail_share_all_sms``
  counts the card's SMs that ran none, too);
- the sections' shares of a warp's transition cycles (``clock()`` marks
  in ``transition``): the body, the leapfrog's element-wise loops, an even
  leaf's stack stores, the merges' stack traffic, the warp sums, the
  block-wide votes while the chain builds (``sync``) and while it waits
  for its block's deepest chain (``wait``), the rest; ``cycles_per_step``
  each section's cycles per leaf step of the block, and the leaf steps and
  leaves built per chain;
- from the side rows (where the sources have ``side_clocks_bind``): the
  n x n products a chain-draw (a warp's matvec, or a block-wide product
  once for each chain of its block), for the low-rank metric instead its
  velocities a chain-draw (``velocities_per_chain_draw``: each velocity
  and, in the fused kernel, the momentum's thin matvecs; a parent's
  sources count them only with the marks of this checkout copied in),
  and for the fused kernel each part
  of a draw around the transition in cycles a chain-draw and its share
  (the normals and the momentum, the start velocity and energy, the
  transition, the work after it, the pooled Welford adds).

An HMC line names its sections otherwise (``HMC_SECTIONS``: the body's
product, the dense metric's velocity products, the kick and drift loops
with their staging, the energies' sums, the fused draw's momentum, the
Welford adds, ``wait``: a chain past its count in its block's lockstep and
the block-wide waits for its longest chain, the rest), each section's share
of the block's cycles and its cycles a lockstep step; the steps a chain
and a draw (the chain's own and its block's lockstep ones), and from the
step counts (inputs or outputs) their mean, their largest, and the mean of
each CUDA block's largest a draw (``block_max_steps_per_draw``, the
steps a lockstep block runs).

Each line also holds ``digest``, a hash of the package build's outputs
(every output tensor's bytes), so that two checkouts whose kernels round
alike show the same digest. A checkout whose sources lack the clocks (no
``transition_clocks_bind``) is timed without them. ``--cases`` runs only
the cases named (the keys of ``_inputs``). ``run_clocks`` is what
``torch_kernel_ab.py`` calls.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

SECTIONS = ("body", "leapfrog", "leaf_store", "merge", "warp_sums", "sync", "wait", "other")
SLOTS = len(SECTIONS) + 2  # then leaf steps and leaves built (kClkSlots)
# the side rows' slots (kSide* in csrc/nuts_transition.cuh): the fused
# kernel's draw in parts (the normals and momentum, the start velocity and
# energy, the transition, the work after it, the pooled Welford adds), its
# draws, and the n x n products
SIDE = ("momentum", "start", "tree", "after", "welford", "draws", "products")
SIDE_SLOTS = len(SIDE)
# the HMC kernels' sections (kHClk* in csrc/hmc_transition.cuh), in the same
# slots; the step slots hold the block's lockstep steps and the chain's own
HMC_SECTIONS = ("body", "velocity", "kick_drift", "energy", "momentum", "welford", "wait",
                "other")
C, N, DEPTH, CB = 1024, 100, 10, 8
# the op each case kind runs, and its library
KINDS = {"trajectory": "nuts_trajectory", "fused_nuts": "fused_nuts",
         "hmc_trajectory": "hmc_trajectory", "fused_hmc": "fused_hmc"}


def _start_clocked(root: Path, out_dir: Path, names) -> dict:
    """Start nvcc on ROOT's kernels ``names`` with the clocks, all at once,
    into ``out_dir``/<hash of ROOT's sources> (a library already there is
    kept): name -> (library path, log path, process or None)."""
    from littlemcmc_torch.ops import _build

    csrc = root / "littlemcmc_torch" / "ops" / "csrc"
    h = hashlib.sha256(" ".join(_build.BUILD_FLAGS).encode())
    for src in sorted(csrc.glob("*.cu*")):
        h.update(src.name.encode() + src.read_bytes())
    out_dir = out_dir / h.hexdigest()[:16]
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib, log = out_dir / f"lib{name}_clocks.so", out_dir / f"{name}_clocks.log"
        proc = None
        if not lib.exists():
            cmd = [_build._nvcc(), *_build.BUILD_FLAGS, "-DLMC_TRANSITION_CLOCKS", "-o",
                   str(lib), str(csrc / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=open(log, "w"), stderr=subprocess.STDOUT)
        procs[name] = (lib, log, proc)
    return procs


def _finish_clocked(procs: dict) -> dict:
    """Wait for :func:`_start_clocked`'s builds: name -> (library path,
    ptxas lines)."""
    out = {}
    for name, (lib, log, proc) in procs.items():
        if proc is not None and proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on {name} with the clocks:\n{log.read_text()}")
        out[name] = (lib, [ln.strip() for ln in log.read_text().splitlines()
                           if "registers" in ln or "spill" in ln or "entry" in ln])
    return out


def _load_clocked(path: Path, name: str):
    """The instrumented library with the package's signatures, its clock
    binder and its side rows' binder (each None where the sources lack
    them)."""
    from littlemcmc_torch.ops import _build

    lib = _build._declare(ctypes.CDLL(str(path)), _build._SIGNATURES[name])
    binders = []
    for fn in ("transition_clocks_bind", "side_clocks_bind"):
        bind = getattr(lib, fn, None)
        if bind is not None:
            bind.restype, bind.argtypes = ctypes.c_int, [ctypes.c_void_p]
        binders.append(bind)
    return lib, binders[0], binders[1]


# The cells whose final states the cases start from, each sampled once
# (seed 42, 1024 chains, 500 + 1000) with the first checkout run and kept
# in build/ beside this script: the main path (``CorrelatedGaussian(100)``,
# per-draw diag), F1 (``NealsFunnel(10)``, centred, ``target_accept=0.9``,
# fused diag), L0 (``SpikedGaussian(100)``, ``jitter+adapt_diag``,
# per-draw diag on body 4), ``adapt_full`` on the 100-d Gaussian (the
# pooled dense metric) on the fused engine and on its per-draw twin
# (``fuse_draws=False``), and L1 and L2 (``SpikedGaussian(100)``,
# ``jitter+adapt_lowrank``: the pooled low-rank metric, fused and per
# draw); and eight schools' NUTS cell (``EightSchools()``, chip_smoke.py's
# ES_CHAINS, ES_TUNE, ES_DRAWS and ES_TARGET: 10,240 chains, 500 + 500,
# ``target_accept=0.95``), on the fused diag engine and on its per-draw twin;
# HMC's main path (``HamiltonianMC(model_ndim=100)``, per-draw diag),
# HMC ``adapt_full`` (the pooled dense metric on the fused engine), L3 (L1
# with ``HamiltonianMC``: the pooled low-rank metric on the fused HMC
# kernel) and eight schools' HMC cell (as its NUTS cell, with
# ``HamiltonianMC``: the fused diag engine).
STATE_FILES = {"main": "transition_clocks_state.pt", "f1": "transition_clocks_f1_state.pt",
               "l0": "transition_clocks_l0_state.pt",
               "adapt_full": "transition_clocks_adapt_full_state.pt",
               "adapt_full_twin": "transition_clocks_adapt_full_twin_state.pt",
               "l1": "transition_clocks_l1_state.pt", "l2": "transition_clocks_l2_state.pt",
               "es_fused": "transition_clocks_es_fused_state.pt",
               "es_twin": "transition_clocks_es_twin_state.pt",
               "hmc": "transition_clocks_hmc_state.pt",
               "hmc_adapt_full": "transition_clocks_hmc_adapt_full_state.pt",
               "l3": "transition_clocks_l3_state.pt",
               "hmc_es": "transition_clocks_hmc_es_state.pt"}


def metric_state(pot, ndim: int) -> dict:
    """The metric's tensors a case reads from a final state's potential:
    ``var``, the inverse mass (diag) or the variances (low-rank); for the
    pooled dense metric ``var`` is the shared covariance and ``linv`` its
    inverse lower Cholesky factor; for the pooled low-rank metric also
    ``stds``, the chains' scales (the per-draw kernel's ``var``), and
    ``fac``, the factor block both kernels read."""
    import torch
    from littlemcmc_torch.nuts import _shared_lowrank_factor

    if hasattr(pot, "cov"):
        return {"var": pot.cov[0], "linv": torch.linalg.solve_triangular(
            pot.chol[0], torch.eye(ndim, device=pot.cov.device), upper=False)}
    fac = _shared_lowrank_factor(pot, True)
    if fac is not None:
        return {"var": pot.var, "stds": pot.stds, "fac": fac}
    return {"var": pot.var}


def _final_state(path: Path, model, chains: int = C, tune: int = 500, draws: int = 1000,
                 **kw) -> dict:
    """A cell's final state (``sample()`` of ``chains`` chains, ``tune`` +
    ``draws``, seed 42 and ``kw``, sampled once, then loaded): the
    trajectory and fused ops' inputs, a momentum from a fixed seed, and
    the metric's tensors (:func:`metric_state`)."""
    import torch

    if path.exists():
        return torch.load(path)
    from littlemcmc_torch import sample

    _, _, s = sample(model.logp_grad, model_ndim=model.ndim, chains=chains, tune=tune,
                     draws=draws, random_seed=42, return_final_state=True, progressbar=False,
                     compute_convergence_checks=False, **kw)
    da, pot = s.da, s.potential
    metric = metric_state(pot, model.ndim)
    state = {k: v.contiguous().clone() for k, v in dict(
        q=s.q, grad=s.q_grad, logp=s.logp, **metric,
        p=pot.sample_momentum(torch.Generator(device=s.q.device).manual_seed(7)),
        iter=s.iter_count.float(), log_step=da.log_step, log_bar=da.log_bar, hbar=da.hbar,
        count=da.count.float(), mu=da.mu).items()}
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(state, path)
    return state


def _inputs(root: Path, state_dir: Path, only=None, kinds_only: bool = False) -> dict:
    """case -> (kernel, model, positional args, seed words, keywords of the
    op beyond the model's spec and the chain block), for the cases in
    ``only`` (default all; a final state is sampled or loaded only for a
    case that reads it; ``kinds_only``: case -> kernel, nothing sampled): rows 1 diag and 2b body 1 (the correlated
    Gaussian) at phase 2's input and the main path's final state; row 2a
    (the funnel's fused instance) at F1's final state and phase 2p's
    draw-chunk input; the funnel in the per-draw kernel at phase 2o's
    input; row 1 body 4 (the spiked Gaussian per draw) at L0's final state
    and phase 2m's input; the spiked Gaussian's fused instance in a 2-draw
    chunk of 256 chains at phase 2m's positions; row 2 dense (the
    correlated Gaussian's fused instance with the pooled dense metric) in
    a 250-draw chunk at ``adapt_full``'s final state and in phase 2c's tune
    chunk as the cell runs it (4 draws, ``adapt_dense`` across a window
    swap, the step size adapting); row 1 dense (the same body per draw) at
    phase 2b's input and at the per-draw twin's final state; rows 2c and 1
    low-rank (the spiked Gaussian with the pooled low-rank metric) at L1's
    final state (a 250-draw chunk) and at L2's final state and phase 2m's
    low-rank input (per draw); rows 2b body 2 and 1 body 2 (eight schools)
    in a 250-draw chunk at the NUTS ``fused_diag`` cell's final state, one
    launch at its per-draw twin's final state (10,240 chains each) and one
    at phase 2f's input (1024 chains); rows 3 and 4 dense (HMC on the
    correlated Gaussian): the per-draw kernel at the HMC main path's final
    state (:func:`hmc_steps`) and at phase 2d's input, the fused dense
    instance in a 250-draw chunk at HMC ``adapt_full``'s final state and in
    phase 2e's tune chunk as that cell runs it (4 draws, ``adapt_dense``
    across a window swap, the step size adapting); rows 4c and 4b (the
    fused HMC kernel's low-rank instance on the spiked Gaussian and its
    diag instance on eight schools): a 250-draw chunk at L3's and at the
    eight-schools HMC cell's final state, and each cell's 4-draw tune chunk
    (:func:`hmc_tune_chunk`)."""
    import functools

    import numpy as np
    import torch

    sys.path.insert(0, str(root))
    import chip_smoke
    from littlemcmc_torch import NUTS, HamiltonianMC
    from littlemcmc_torch.base import HMCConfig, NUTSConfig
    from littlemcmc_torch.models import (CorrelatedGaussian, EightSchools, NealsFunnel,
                                         SpikedGaussian)

    on = {"device": "cpu"} if kinds_only else {}  # kinds_only runs on a machine without a card
    cg, fun, sg, es = (CorrelatedGaussian(N, **on), NealsFunnel(10, **on), SpikedGaussian(N, **on),
                       EightSchools(**on))
    es_step = dict(chains=chip_smoke.ES_CHAINS, tune=chip_smoke.ES_TUNE,
                   draws=chip_smoke.ES_DRAWS,
                   step=NUTS(model_ndim=es.ndim, target_accept=chip_smoke.ES_TARGET))
    cells = {"main": (cg, {}), "f1": (fun, dict(target_accept=0.9)),
             "l0": (sg, dict(init="jitter+adapt_diag")),
             "adapt_full": (cg, dict(init="adapt_full")),
             "adapt_full_twin": (cg, dict(init="adapt_full", fuse_draws=False)),
             "l1": (sg, dict(init="jitter+adapt_lowrank")),
             "l2": (sg, dict(init="jitter+adapt_lowrank", fuse_draws=False)),
             "es_fused": (es, es_step), "es_twin": (es, dict(es_step, fuse_draws=False)),
             "hmc": (cg, dict(step=HamiltonianMC(model_ndim=N))),
             "hmc_adapt_full": (cg, dict(init="adapt_full", step=HamiltonianMC(model_ndim=N))),
             "l3": (sg, dict(init="jitter+adapt_lowrank", step=HamiltonianMC(model_ndim=N))),
             "hmc_es": (es, dict(es_step, step=HamiltonianMC(model_ndim=es.ndim,
                                                            target_accept=chip_smoke.ES_TARGET)))}

    @functools.lru_cache(maxsize=None)
    def state(key):
        model, kw = cells[key]
        return _final_state(state_dir / STATE_FILES[key], model, **kw)

    @functools.lru_cache(maxsize=None)
    def stationary():
        return chip_smoke._stationary_inputs(cg, np.linalg.cholesky(cg.cov), C, 0.2, seed=0)

    f = dict(dtype=torch.float32, device="cuda")
    diag, dense = dict(metric="diag"), dict(metric="dense")

    def traj(s, var="var"):
        depth = torch.full((s["q"].shape[0],), DEPTH, dtype=torch.int32, device="cuda")
        return (s["q"], s["p"], s["grad"], s["logp"], torch.exp(s["log_bar"]), depth, s[var])

    def fused(s):
        return (s["q"], s["grad"], s["logp"], s["iter"], s["log_step"], s["log_bar"], s["hbar"],
                s["count"], s["mu"], s["var"], s.get("linv"))

    def draws(T, metric="diag", config=None):
        return dict(T=T, tuning=False, config=config or NUTSConfig(), metric=metric)

    def chunk(model, chains, seed):  # the smoke's diag draw-chunk input (fused_check)
        return chip_smoke._diag_fused_inputs(model, chains, seed, False, swap_at=1)[0]

    def fused_phase2():
        q, _, g, lp, eps, _, var = stationary()
        leps = torch.log(eps)
        return (q, g, lp, torch.full((C,), 1500.0, **f), leps, leps, torch.zeros(C, **f),
                torch.full((C,), 40.0, **f), leps + float(np.log(10.0)), var, None)

    def lowrank_2m():
        return chip_smoke._lowrank_inputs(sg, C, 0.5, seed=23)

    def hmc_final():
        s = state("hmc")
        eps = torch.exp(s["log_bar"])
        return (s["q"], s["p"], s["grad"], s["logp"], eps, hmc_steps(eps, HMCConfig()), s["var"])

    cases = {
        "phase2": ("trajectory", lambda: (cg, stationary(), (17, 29), diag)),
        "main_final": ("trajectory", lambda: (cg, traj(state("main")), (3, 8), diag)),
        "fused_phase2": ("fused_nuts", lambda: (cg, fused_phase2(), (5, 9), draws(250))),
        "fused_main_final": ("fused_nuts", lambda: (cg, fused(state("main")), (5, 9),
                                                    draws(250))),
        "f1_final": ("fused_nuts", lambda: (fun, fused(state("f1")), (5, 9), draws(250))),
        "phase2p": ("fused_nuts", lambda: (fun, chunk(fun, C, 35), (211, 7), draws(2))),
        "phase2o": ("trajectory", lambda: (fun, chip_smoke._posterior_inputs(fun, C, 0.2, 33),
                                           (197, -5), diag)),
        "l0_final": ("trajectory", lambda: (sg, traj(state("l0")), (3, 8), diag)),
        "phase2m": ("trajectory", lambda: (sg, chip_smoke._posterior_inputs(sg, 256, 0.1, 25),
                                           (163, 167), diag)),
        "fused_phase2m": ("fused_nuts", lambda: (sg, chunk(sg, 256, 25), (229, 7), draws(2))),
        "adapt_full_final": ("fused_nuts", lambda: (cg, fused(state("adapt_full")), (5, 9),
                                                    draws(250, "dense"))),
        "phase2c_tune": ("fused_nuts", lambda: (
            cg, chip_smoke._fused_inputs(cg, C, 5), (47, 13),
            dict(T=4, tuning=True, config=NUTSConfig(adapt_step_size=True), metric="dense",
                 window_multiplier=2.0, dense_welford=chip_smoke._welford_seed(cg)))),
        "phase2b": ("trajectory", lambda: (
            cg, chip_smoke._dense_stationary_inputs(cg, C, 0.5, seed=2), (23, 31), dense)),
        "twin_final": ("trajectory", lambda: (cg, traj(state("adapt_full_twin")), (3, 8),
                                              dense)),
        "l1_final": ("fused_nuts", lambda: (sg, fused(state("l1")), (5, 9),
                                            dict(draws(250, "lowrank"), fac=state("l1")["fac"]))),
        "l2_final": ("trajectory", lambda: (sg, traj(state("l2"), "stds"), (3, 8),
                                            dict(metric="lowrank", fac=state("l2")["fac"]))),
        "phase2m_lowrank": ("trajectory", lambda: (sg, lowrank_2m()[0], (139, -149),
                                                   dict(metric="lowrank", fac=lowrank_2m()[1]))),
        "es_fused_final": ("fused_nuts", lambda: (
            es, fused(state("es_fused")), (5, 9),
            draws(250, config=NUTSConfig(target_accept=chip_smoke.ES_TARGET)))),
        "es_per_draw_final": ("trajectory", lambda: (es, traj(state("es_twin")), (3, 8), diag)),
        "phase2f": ("trajectory", lambda: (es, chip_smoke._posterior_inputs(es, 1024, 0.3, 11),
                                           (83, -89), diag)),
        "hmc_final": ("hmc_trajectory", lambda: (cg, hmc_final(), (3, 8), {})),
        "hmc_phase2d": ("hmc_trajectory", lambda: (cg, chip_smoke._hmc_inputs(
            cg, np.linalg.cholesky(cg.cov), C, 0.2, 6), (61, -67), {})),
        "hmc_af_final": ("fused_hmc", lambda: (cg, fused(state("hmc_adapt_full")), (5, 9),
                                               draws(250, "dense", HMCConfig()))),
        "hmc_af_tune": ("fused_hmc", lambda: (
            cg, chip_smoke._fused_inputs(cg, C, 10), (67, 19),
            dict(T=4, tuning=True, config=HMCConfig(adapt_step_size=True), metric="dense",
                 window_multiplier=2.0, dense_welford=chip_smoke._welford_seed(cg)))),
        "hmc_l3_final": ("fused_hmc", lambda: (
            sg, fused(state("l3")), (5, 9),
            dict(draws(250, "lowrank", HMCConfig()), fac=state("l3")["fac"]))),
        "hmc_l3_tune": ("fused_hmc", lambda: (sg, *hmc_tune_chunk(sg, C, 41, "lowrank"))),
        "hmc_es_final": ("fused_hmc", lambda: (
            es, fused(state("hmc_es")), (5, 9),
            draws(250, config=HMCConfig(target_accept=chip_smoke.ES_TARGET)))),
        "hmc_es_tune": ("fused_hmc", lambda: (es, *hmc_tune_chunk(
            es, chip_smoke.ES_CHAINS, 43, "diag", chip_smoke.ES_TARGET))),
    }
    unknown = set(only or ()) - set(cases)
    if unknown:
        raise ValueError(f"unknown cases {sorted(unknown)}; known: {sorted(cases)}")
    chosen = {k: v for k, v in cases.items() if not only or k in only}
    if kinds_only:
        return {k: kind for k, (kind, _) in chosen.items()}
    return {k: (kind, *make()) for k, (kind, make) in chosen.items()}


def hmc_tune_chunk(model, chains: int, seed: int, metric: str, target_accept=None,
                   T: int = 4):
    """A fused HMC tune chunk as a cell with a per-chain metric runs it
    (``chip_smoke.py``'s inputs, made on its ``DEVICE``): ``T`` draws, the
    step size adapting, the per-chain Welford steps across a window swap
    at draw 2 (``_diag_fused_inputs``), window multiplier 2; ``metric``
    ``"diag"`` (eight schools) or ``"lowrank"`` (the variances near the
    spiked Gaussian's squared scales, its spikes as the factor,
    ``_model_fac``). Returns the op's arguments, its seed words and its
    keywords beyond the model's spec and the chain block."""
    import chip_smoke
    from littlemcmc_torch.base import HMCConfig

    lowrank = metric == "lowrank"
    args, welford = chip_smoke._diag_fused_inputs(
        model, chains, seed, True, swap_at=2,
        var_sd=chip_smoke._lowrank_metric(model)[0] if lowrank else None)
    cfg = HMCConfig(adapt_step_size=True) if target_accept is None else HMCConfig(
        adapt_step_size=True, target_accept=target_accept)
    kw = dict(T=T, tuning=True, config=cfg, metric=metric, window_multiplier=2.0,
              welford=welford)
    if lowrank:
        kw["fac"] = chip_smoke._model_fac(model, args[0].device)
    return args, (seed, -seed - 2), kw


def hmc_steps(eps, config, seed: int = 11):
    """Each chain's step count as the HMC sampler draws it (``hmc.py``):
    ``clamp(floor(U(0, 1) * path_length / eps), 1, max_steps)``, the
    uniforms from a generator seeded ``seed`` on ``eps``'s device."""
    import torch

    gen = torch.Generator(device=eps.device).manual_seed(seed)
    path = torch.rand(eps.shape[0], generator=gen, device=eps.device) * config.path_length
    return torch.clamp(torch.floor(path / eps), 1, config.max_steps).to(torch.int32)


def clock_buffer_len(chains: int, cb: int) -> int:
    """int64 words of the clocks' side buffer for a launch of ``chains``
    chains in blocks of ``cb``: a row of kClkSlots a chain, then (start
    ns, end ns, SM, unused) a block."""
    return chains * SLOTS + (chains // cb) * 4


def _tail(blocks, n_sms: int) -> dict:
    """The grid's tail from the blocks' (start ns, end ns, SM) rows."""
    import numpy as np

    blocks = blocks[blocks[:, 1] > 0]  # rows of blocks that ran (a buffer may hold more)
    start, end, sm = (blocks[:, k].astype(np.float64) for k in range(3))
    span = end.max() - start.min()
    busy = {}
    for s_, e_, m in zip(start, end, sm):  # an SM's busy time: its blocks' first start to last end
        lo, hi = busy.get(m, (s_, e_))
        busy[m] = (min(lo, s_), max(hi, e_))
    used = sum(hi - lo for lo, hi in busy.values())
    dur = end - start
    return {"span_ms": span / 1e6, "blocks": int(len(start)), "sms_used": len(busy),
            "block_ms_min": float(dur.min()) / 1e6, "block_ms_median": float(np.median(dur)) / 1e6,
            "block_ms_mean": float(dur.mean()) / 1e6, "block_ms_max": float(dur.max()) / 1e6,
            "tail_share": 1.0 - used / (len(busy) * span),
            "tail_share_all_sms": 1.0 - used / (n_sms * span)}


def _sections(rows) -> dict:
    """Section shares and cycles per leaf step from the chains' rows."""
    import numpy as np

    cyc = rows[:, :len(SECTIONS)].astype(np.float64)
    steps = rows[:, len(SECTIONS)].astype(np.float64)
    built = rows[:, len(SECTIONS) + 1].astype(np.float64)
    total = cyc.sum()
    out = {f"share_{k}": float(cyc[:, i].sum() / total) for i, k in enumerate(SECTIONS)}
    out.update({f"cycles_per_step_{k}": float(cyc[:, i].sum() / steps.sum())
                for i, k in enumerate(SECTIONS)})
    out.update(cycles_per_step=float(total / steps.sum()),
               leaf_steps_per_chain=float(steps.mean()), leaves_built_per_chain=float(built.mean()))
    return out


def _hmc_sections(rows, draws: int) -> dict:
    """The HMC kernels' section shares (``HMC_SECTIONS``) of the chains'
    cycles, each section's cycles a lockstep step, the wait share, and the
    steps a chain-draw: its block's lockstep steps and its own."""
    import numpy as np

    cyc = rows[:, :len(HMC_SECTIONS)].astype(np.float64)
    lock = rows[:, len(HMC_SECTIONS)].astype(np.float64)
    own = rows[:, len(HMC_SECTIONS) + 1].astype(np.float64)
    total = cyc.sum()
    out = {f"share_{k}": float(cyc[:, i].sum() / total) for i, k in enumerate(HMC_SECTIONS)}
    out.update({f"cycles_per_step_{k}": float(cyc[:, i].sum() / lock.sum())
                for i, k in enumerate(HMC_SECTIONS)})
    out.update(cycles_per_step=float(total / lock.sum()), wait_share=out["share_wait"],
               lockstep_steps_per_chain_draw=float(lock.mean() / draws),
               steps_per_chain_draw=float(own.mean() / draws))
    return out


def _hmc_step_counts(n_steps, chains_per_block: int) -> dict:
    """From the step counts (``(T, C)``, or ``(C,)`` for one draw): their
    mean and largest, and the mean over draws and CUDA blocks of
    ``chains_per_block`` chains of each block's largest (the steps a block
    that integrates in lockstep runs a draw), and that over the mean."""
    import numpy as np

    x = np.asarray(n_steps, dtype=np.float64).reshape(-1, np.shape(n_steps)[-1])
    T, chains = x.shape
    pad = -chains % chains_per_block  # a last block that is not full
    x = np.concatenate([x, np.zeros((T, pad))], axis=1)
    block_max = x.reshape(T, -1, chains_per_block).max(-1)
    mean = float(np.asarray(n_steps, dtype=np.float64).mean())
    return {"mean_steps": mean, "max_steps": int(np.max(n_steps)),
            "block_max_steps_per_draw": float(block_max.mean()),
            "lockstep_step_ratio": float(block_max.mean()) / mean}


def _side(rows, draws: int, metric: str = "diag") -> dict:
    """From the chains' side rows (``[C][SIDE_SLOTS]``): each part of the
    fused kernel's draw (``SIDE``) in cycles a chain-draw and its share of
    the draw, the share outside the transition, and the n x n products a
    chain-draw, for the low-rank metric its velocities a chain-draw (a
    per-draw launch is one draw; its rows hold the transition's products
    or velocities only)."""
    import numpy as np

    rows = rows.astype(np.float64)
    chain_draws = rows[:, SIDE.index("draws")].sum() or rows.shape[0] * draws
    what = "velocities" if metric == "lowrank" else "products"
    out = {f"{what}_per_chain_draw": float(rows[:, SIDE.index("products")].sum() / chain_draws)}
    parts = SIDE[:5]
    total = rows[:, :5].sum()
    if total > 0:
        out.update({f"draw_cycles_{k}": float(rows[:, i].sum() / chain_draws)
                    for i, k in enumerate(parts)})
        out.update({f"draw_share_{k}": float(rows[:, i].sum() / total)
                    for i, k in enumerate(parts)})
        out["draw_share_outside_transition"] = 1.0 - float(
            rows[:, SIDE.index("tree")].sum() / total)
    return out


def _digest(out: dict) -> str:
    """A hash of every output tensor's bytes, in key order."""
    h = hashlib.sha256()
    for k in sorted(out):
        if out[k] is not None:
            h.update(k.encode())
            h.update(out[k].contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _ms(fn, reps: int) -> float:
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _blocks_per_sm(lib_name: str):
    """Blocks an SM of the package build's last launch of ``lib_name``
    (its ``*_last_blocks_per_sm``), or None where the library lacks it."""
    from littlemcmc_torch.ops import _build

    fn = getattr(_build.load_library(lib_name), f"{lib_name}_last_blocks_per_sm", None)
    return int(fn()) if fn is not None else None


def run_clocks(root: Path, state_dir: Path, out_dir: Path, only=None) -> list:
    """Every launch's JSON record for the checkout at ``root`` (its package
    already on ``sys.path``); ``only``: the cases to run (default all)."""
    import torch
    from littlemcmc_torch.ops import _build
    from littlemcmc_torch.ops.fused_hmc import fused_hmc
    from littlemcmc_torch.ops.fused_nuts import fused_nuts
    from littlemcmc_torch.ops.hmc_trajectory import hmc_trajectory
    from littlemcmc_torch.ops.nuts_trajectory import trajectory

    t0 = time.perf_counter()
    # the instrumented builds of the kernels the cases run only
    kinds = _inputs(root, state_dir, only, kinds_only=True)
    procs = _start_clocked(root, out_dir, sorted({KINDS[k] for k in kinds.values()}))
    _build.build_all()  # the package's own build, beside the clocked one
    clocked = _finish_clocked(procs)
    build_s = time.perf_counter() - t0
    libs = {name: _load_clocked(path, name) for name, (path, _) in clocked.items()}
    cases = _inputs(root, state_dir, only)
    import chip_smoke  # root's, which _inputs put on sys.path
    ops = {"trajectory": trajectory, "fused_nuts": fused_nuts, "hmc_trajectory": hmc_trajectory,
           "fused_hmc": fused_hmc}
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    real_load = _build.load_library
    records = []
    for case, (kind, model, args, seed, extra) in cases.items():
        if only and case not in only:
            continue
        op, lib_name = ops[kind], KINDS[kind]
        hmc = kind in ("hmc_trajectory", "fused_hmc")
        chains = args[0].shape[0]
        metric = extra.get("metric", "diag")
        # the per-draw HMC op's chain block is its counter stream's (512 by
        # default), not the kernel's thread block
        kw = dict(spec=model.trajectory_spec(), **extra)
        if kind != "hmc_trajectory":
            kw["chain_block"] = CB
        if kind == "trajectory":
            kw.update(max_treedepth=DEPTH, Emax=1000.0)
        if kind == "hmc_trajectory":
            kw["Emax"] = 1000.0
        T = extra.get("T", 0)
        reps = 3 if T >= 100 else 20

        def call():
            return op(*args, seed, **kw)

        digest = _digest(call())
        blocks_per_sm = _blocks_per_sm(lib_name)
        plain_build_ms = _ms(call, reps)
        # the HMC cases' device time under the profiler: a per-draw HMC
        # launch is shorter than its wrapper's host work
        device_ms = chip_smoke._device_ms(call, lib_name, reps, None)[0] if hmc else None
        lib, bind, bind_side = libs[lib_name]
        _build.load_library = (lambda name, _l=lib, _n=lib_name:
                               _l if name == _n else real_load(name))
        try:
            instr_ms = _ms(call, reps)
            rec = {"root": str(root), "case": case, "kernel": lib_name,
                   "body": model.trajectory_spec().body, "metric": metric,
                   "chains": chains, "draws": T or 1, "ms": instr_ms,
                   "plain_build_ms": plain_build_ms, "device_ms": device_ms, "digest": digest,
                   "blocks_per_sm": blocks_per_sm,
                   "waves": (chains // CB / (blocks_per_sm * n_sms) if blocks_per_sm else None),
                   "ptxas_clocks": clocked[lib_name][1]}
            if bind is not None:
                # the per-draw HMC kernel's thread blocks may hold fewer than
                # CB chains: room for a block row a chain
                buf = torch.zeros(clock_buffer_len(chains, 1 if hmc else CB),
                                  dtype=torch.int64, device="cuda")
                side = torch.zeros(chains * SIDE_SLOTS, dtype=torch.int64, device="cuda")
                if bind(buf.data_ptr()) != 0 or (
                        bind_side is not None and bind_side(side.data_ptr()) != 0):
                    raise RuntimeError("transition_clocks_bind or side_clocks_bind failed")
                out = call()
                torch.cuda.synchronize()
                host = buf.cpu().numpy()
                bind(0)
                if bind_side is not None:
                    bind_side(0)
                    rec.update(_side(side.cpu().numpy().reshape(chains, SIDE_SLOTS), T or 1,
                                     extra["metric"]))
                rec.update(_tail(host[chains * SLOTS:].reshape(-1, 4), n_sms))
                rows = host[:chains * SLOTS].reshape(chains, SLOTS)
                if hmc:
                    rec.update(_hmc_sections(rows, T or 1))
                    per_block = -(-chains // rec["blocks"])
                    steps = out["n_steps"] if kind == "fused_hmc" else args[5]
                    rec.update(chains_per_block=per_block,
                               **_hmc_step_counts(steps.cpu().numpy(), per_block))
                    if blocks_per_sm:
                        rec["waves"] = rec["blocks"] / (blocks_per_sm * n_sms)
                else:
                    rec.update(_sections(rows))
                    rec["mean_leaves_per_chain_draw"] = float(
                        out["n_leaves"].float().mean())
                    rec["max_depth"] = int(out["depth"].max())
            else:
                rec["clocks"] = "none: the checkout's sources have no section clocks"
        finally:
            _build.load_library = real_load
        rec["build_seconds"] = build_s
        records.append(rec)
    return records


def main() -> int:
    here = Path(__file__).resolve().parents[1]
    opts = [a for a in sys.argv[1:] if a.startswith("--")]
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    only = [c for a in opts if a.startswith("--cases=") for c in a[8:].split(",")]
    root = Path(args[0] if args else here).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "root": str(root)}), flush=True)
    for rec in run_clocks(root, here / "build", here / "build" / "transition_clocks", only):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
