"""The port's CUDA kernels on the card, held against their plain versions.

Imports no JAX, so it runs on a machine with a CUDA card and PyTorch alone:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` skips the repository's conftest files, which set up
JAX.) Every test here needs a CUDA device of compute capability 9.0 and
skips elsewhere. Each kernel and its plain version draw the same counter
stream, so they build the same trees; the correlated Gaussian's matvecs
(and the dense metric's) sum in another order in each, and a rounding
difference can flip one decision and, through the block's shared
counter, the rest of its block. The fused kernels' checks are those of
``chip_smoke.py``'s phases 2c and 2e (:func:`chip_smoke.fused_check`), the
HMC trajectory kernel's those of phase 2d (:func:`chip_smoke.hmc_check`),
at fewer chains.
"""

import numpy as np
import pytest
import torch

from littlemcmc_torch import NUTS, HamiltonianMC, models as tm
from littlemcmc_torch import sample
from littlemcmc_torch.ops import trajectory, trajectory_plain

from chip_smoke import (FLAGS, _held, _hmc_inputs, _positions, _posterior_sd, fused_check,
                        hmc_check)


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs a CUDA device of compute capability 9.0 (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False  # matmuls feed comparisons
    return torch.device("cuda")


def _inputs(model, chol, C, D, eps, seed, dev):
    rng = np.random.default_rng(seed)
    n = model.ndim
    q = torch.from_numpy((rng.standard_normal((C, n)) @ chol.T).astype(np.float32)).to(dev)
    var = (model.true_var * rng.uniform(0.5, 2.0, (C, n))).astype(np.float32)
    p = (rng.standard_normal((C, n)) / np.sqrt(var)).astype(np.float32)
    eps = (eps * rng.uniform(0.8, 1.2, C)).astype(np.float32)
    mdc = np.full(C, D, np.int32)
    mdc[::5] = D - 2  # some chains carry the early tree-depth cap
    logp, grad = model.batched_logp_grad(q)
    return (q, torch.from_numpy(p).to(dev), grad.contiguous(), logp.contiguous(),
            torch.from_numpy(eps).to(dev), torch.from_numpy(mdc).to(dev),
            torch.from_numpy(var).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("body,n,chains,block,integrator", [
    ("standard_normal", 4, 1024, 8, "leapfrog"),
    ("standard_normal", 4, 256, 8, "three_stage"),
    ("correlated_gaussian", 100, 1024, 8, "leapfrog"),
    ("correlated_gaussian", 20, 256, 16, "two_stage"),
    # the precision (160 KB) does not fit beside the working states in
    # shared memory: the kernel reads it from global memory
    ("correlated_gaussian", 200, 256, 8, "leapfrog"),
])
def test_kernel_matches_plain(hopper, body, n, chains, block, integrator):
    model = tm.StandardNormal(n) if body == "standard_normal" else tm.CorrelatedGaussian(n)
    chol = np.eye(n) if body == "standard_normal" else np.linalg.cholesky(model.cov)
    D = 10
    args = _inputs(model, chol, chains, D, 0.5 if n == 4 else 0.2, 3, hopper)
    kw = dict(spec=model.trajectory_spec(), max_treedepth=D, Emax=1000.0,
              chain_block=block, integrator=integrator)
    launches = trajectory.launches
    got = trajectory(*args, (9, 4), **kw)
    torch.cuda.synchronize()
    assert trajectory.launches == launches + 1
    want = trajectory_plain(*args, (9, 4), **kw)
    agree = torch.stack([got[k] == want[k] for k in FLAGS]).all(0)
    assert float(agree.float().mean()) >= (1.0 if body == "standard_normal" else 0.99)
    assert float(want["depth"].float().mean()) > 2
    scale = torch.from_numpy(np.sqrt(model.true_var)).float().to(hopper)
    # fp32 rounding of different summation orders, in posterior sds
    assert float(((got["q"] - want["q"]).abs() / scale)[agree].max()) < 1e-4


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(hopper):
    model = tm.CorrelatedGaussian(8)
    args = _inputs(model, np.linalg.cholesky(model.cov), 64, 5, 0.2, 0, hopper)
    kw = dict(spec=model.trajectory_spec(), max_treedepth=5, Emax=1000.0)
    with pytest.raises(ValueError, match="chain_block"):
        trajectory(*args, 1, chain_block=64, **kw)  # one warp per chain: at most 16
    bad = list(args)
    bad[0] = bad[0].cpu()
    with pytest.raises(ValueError, match="expected torch.float32"):
        trajectory(*bad, 1, **kw)  # tensors on two devices


@pytest.mark.cuda
def test_sample_on_the_card_launches_once_per_draw(hopper):
    model = tm.CorrelatedGaussian(20)
    report = {}
    trace, stats = sample(model.logp_grad, model_ndim=20, chains=256, tune=150, draws=150,
                          random_seed=3, perf_report=report, progressbar=False)
    assert report["kernel_launches"] == {"nuts_trajectory": 300, "fused_nuts": 0}
    assert report["trajectory"] == "cuda"
    assert trace.shape == (256, 150, 20) and np.isfinite(trace).all()
    assert stats["diverging"].mean() < 0.01
    assert abs((trace.reshape(-1, 20).var(0) / model.true_var).mean() - 1) < 0.1


def _dense_inputs(model, C, D, eps, seed, dev):
    """Stationary inputs for the true covariance as the dense metric:
    q ~ N(0, cov), p ~ N(0, cov^-1)."""
    rng = np.random.default_rng(seed)
    chol = np.linalg.cholesky(model.cov)
    q = torch.from_numpy((rng.standard_normal((C, model.ndim)) @ chol.T)
                         .astype(np.float32)).to(dev)
    p = np.ascontiguousarray(np.linalg.solve(chol.T, rng.standard_normal((model.ndim, C))).T)
    eps = (eps * rng.uniform(0.8, 1.2, C)).astype(np.float32)
    mdc = np.full(C, D, np.int32)
    mdc[::5] = D - 2
    logp, grad = model.batched_logp_grad(q)
    return (q, torch.from_numpy(p.astype(np.float32)).to(dev), grad.contiguous(),
            logp.contiguous(), torch.from_numpy(eps).to(dev), torch.from_numpy(mdc).to(dev),
            torch.from_numpy(model.cov.astype(np.float32)).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("n,chains,block", [(100, 256, 8), (20, 128, 16)])
def test_dense_kernel_matches_plain(hopper, n, chains, block):
    model = tm.CorrelatedGaussian(n)
    D = 10
    args = _dense_inputs(model, chains, D, 0.5, 5, hopper)
    kw = dict(spec=model.trajectory_spec(), max_treedepth=D, Emax=1000.0,
              chain_block=block, metric="dense")
    launches = trajectory.launches
    got = trajectory(*args, (4, 9), **kw)
    torch.cuda.synchronize()
    assert trajectory.launches == launches + 1
    want = trajectory_plain(*args, (4, 9), **kw)
    agree = torch.stack([got[k] == want[k] for k in FLAGS]).all(0)
    assert float(agree.float().mean()) >= 0.99
    assert float(want["depth"].float().mean()) > 1
    held = _held(agree[None], block)[0]
    assert float(held.float().mean()) >= 0.9
    scale = torch.from_numpy(np.sqrt(model.true_var)).float().to(hopper)
    assert float(((got["q"] - want["q"]).abs() / scale)[held].max()) < 1e-4
    assert float((got["energy"] - want["energy"]).abs()[held].max()) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("tuning", [False, True], ids=["draw_chunk", "tune_chunk"])
def test_fused_kernel_matches_plain(hopper, tuning):
    """Tree for tree, with the step size fixed within the chunk: a static
    draw chunk, and an adapt_dense tune chunk across a window swap; the
    checks of the smoke's phase 2c at 256 chains."""
    res, failures, got, _, _, _ = fused_check(tm.CorrelatedGaussian(100), 256, 4, tuning,
                                              False, seed=8, words=(21, -3))
    assert not failures, res
    if tuning:
        assert float(got["window"]) == 202.0


@pytest.mark.cuda
def test_fused_kernel_tune_chunk_with_dual_averaging(hopper):
    """The tune chunk as the main path runs it. Dual averaging feeds each
    draw's accept statistic into the next draw's step size and amplifies
    rounding, so the kernel's first draw is held tree for tree (stats
    included), its dual-averaging state to the update replayed over its
    own accept statistics, and its pooled Welford state to a float64
    replay of its own trace."""
    res, failures, _, _, _, _ = fused_check(tm.CorrelatedGaussian(100), 256, 4, True, True,
                                            seed=8, words=(21, -3))
    assert not failures, res
    assert res["step_size_adapting"] and "da_tol_share" in res


@pytest.mark.cuda
def test_adapt_full_on_the_card_runs_the_fused_kernel(hopper):
    model = tm.CorrelatedGaussian(20)
    report = {}
    trace, stats = sample(model.logp_grad, model_ndim=20, chains=256, tune=150, draws=150,
                          random_seed=3, init="adapt_full", perf_report=report,
                          progressbar=False)
    # tune chunks 10, 10, 30, 50, 50; one draw chunk
    assert report["engine"] == "fused_dense_pooled"
    assert report["kernel_launches"] == {"nuts_trajectory": 0, "fused_nuts": 6}
    assert trace.shape == (256, 150, 20) and np.isfinite(trace).all()
    assert stats["diverging"].mean() < 0.01
    assert abs((trace.reshape(-1, 20).var(0) / model.true_var).mean() - 1) < 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("body,n,chains,block,integrator", [
    ("standard_normal", 4, 1024, 512, "leapfrog"),
    ("correlated_gaussian", 100, 256, 512, "leapfrog"),
    ("correlated_gaussian", 20, 250, 8, "two_stage"),
    # the precision (250 KB) does not fit in shared memory: the kernel
    # reads it from global memory
    ("correlated_gaussian", 250, 64, 16, "leapfrog"),
])
def test_hmc_kernel_matches_plain(hopper, body, n, chains, block, integrator):
    """The HMC trajectory kernel chain for chain: the checks of the smoke's
    phase 2d, at other shapes, chain blocks and integrators (250 chains:
    a last thread block that is not full)."""
    model = tm.StandardNormal(n) if body == "standard_normal" else tm.CorrelatedGaussian(n)
    chol = np.eye(n) if body == "standard_normal" else np.linalg.cholesky(model.cov)
    args = _hmc_inputs(model, chol, chains, 0.25 if n == 4 else 0.2, 3)
    res, failures, got, _ = hmc_check(model, args, (9, -4), 1.0 if n == 4 else 0.99,
                                      chain_block=block, integrator=integrator)
    assert not failures, res
    assert res["max_n_steps"] > 5 and res["accept_rate"] > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("tuning", [False, True], ids=["draw_chunk", "tune_chunk"])
def test_fused_hmc_kernel_matches_plain(hopper, tuning):
    """The fused HMC kernel chain for chain, step size held: a static draw
    chunk, and an adapt_dense tune chunk across a window swap; the checks of
    the smoke's phase 2e at 256 chains."""
    res, failures, got, _, _, _ = fused_check(tm.CorrelatedGaussian(100), 256, 4, tuning,
                                              False, seed=8, words=(21, -3), step="hmc")
    assert not failures, res
    if tuning:
        assert float(got["window"]) == 202.0


@pytest.mark.cuda
def test_fused_hmc_kernel_tune_chunk_with_dual_averaging(hopper):
    """The fused HMC tune chunk as the adapt_full path runs it: its first
    draw held chain for chain, its dual-averaging state to the update
    replayed over its own accept statistics, its pooled Welford state to a
    float64 replay of its own trace."""
    res, failures, _, _, _, _ = fused_check(tm.CorrelatedGaussian(100), 256, 4, True, True,
                                            seed=8, words=(21, -3), step="hmc")
    assert not failures, res
    assert res["step_size_adapting"] and "da_tol_share" in res


@pytest.mark.cuda
@pytest.mark.parametrize("init,engine,launches", [
    ("jitter+adapt_diag", "per_draw_diag", {"hmc_trajectory": 300, "fused_hmc": 0}),
    # tune chunks 10, 10, 30, 50, 50; one draw chunk
    ("adapt_full", "fused_dense_pooled", {"hmc_trajectory": 0, "fused_hmc": 6}),
])
def test_hmc_sample_on_the_card(hopper, init, engine, launches):
    model = tm.CorrelatedGaussian(20)
    report = {}
    trace, stats = sample(model.logp_grad, model_ndim=20, chains=256, tune=150, draws=150,
                          random_seed=3, init=init, step=HamiltonianMC(model_ndim=20),
                          perf_report=report, progressbar=False)
    assert report["engine"] == engine and report["trajectory"] == "cuda"
    assert report["kernel_launches"] == launches
    assert trace.shape == (256, 150, 20) and np.isfinite(trace).all()
    assert stats["diverging"].mean() < 0.01
    assert abs((trace.reshape(-1, 20).var(0) / model.true_var).mean() - 1) < 0.1


# Body 1 in the per-draw HMC kernel (the diagonal metric) and in the fused
# HMC kernel with the dense metric in chain blocks of up to 8 run the block
# HMC transition (csrc/hmc_transition.cuh): the block's chains in lockstep
# to their longest count, each product of the whole block. Each block
# instance is held against its plain version by the smoke's checks.

@pytest.mark.cuda
@pytest.mark.parametrize("n", [100, 250])
def test_hmc_block_kernel_ragged_counts_match_plain(hopper, n):
    """Ragged counts within each thread block: the first chain of every 8
    at 40 steps and the rest at 1, one chain at a step that diverges
    mid-trajectory (it integrates on to its 20 steps), one at 0 steps; P
    in shared memory (n = 100) and through L2 (n = 250)."""
    from littlemcmc_torch.ops.nuts_trajectory import runs_hmc_block_transition

    assert runs_hmc_block_transition("correlated_gaussian", "diag", 512, fused=False)
    model = tm.CorrelatedGaussian(n)
    q, p, grad, logp, eps, n_steps, var = _hmc_inputs(model, np.linalg.cholesky(model.cov),
                                                      256, 0.2, 5)
    n_steps = torch.ones_like(n_steps)
    n_steps[::8] = 40
    n_steps[3], n_steps[5] = 20, 0
    eps = eps.clone()
    eps[3] = 0.4  # its energy grows past Emax (to 1e15-1e17) and stays finite
    args = (q, p, grad, logp, eps, n_steps, var)
    res, failures, got, want = hmc_check(model, args, (13, -17), 0.99, scaled=True)
    assert not failures, res
    assert bool(want["diverging"][3]) and bool(got["diverging"][3])
    assert res["max_n_steps"] == 40
    # the chain of no steps keeps its start, accepted or not
    torch.testing.assert_close(got["q"][5], q[5], rtol=0, atol=0)
    torch.testing.assert_close(got["grad"][5], grad[5], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,block,tuning", [
    (100, 8, False), (100, 5, False), (100, 1, False), (250, 8, False), (100, 8, True),
    (100, 5, True),
], ids=["draw-100-8", "draw-100-5", "draw-100-1", "draw-250-8", "tune-100-8", "tune-100-5"])
def test_fused_hmc_block_kernel_matches_plain(hopper, n, block, tuning):
    """The fused HMC kernel's dense block instance, step size held: a draw
    chunk at n = 100 in blocks of 8, 5 and 1 chains (ragged products) and at
    n = 250 (P, COV and L^-1 through L2), and an ``adapt_dense`` tune chunk
    across the window swap (the checks of the smoke's phase 2e)."""
    from littlemcmc_torch.ops.nuts_trajectory import runs_hmc_block_transition

    assert runs_hmc_block_transition("correlated_gaussian", "dense", block, fused=True)
    res, failures, got, _, _, _ = fused_check(tm.CorrelatedGaussian(n), 40 * block, 4, tuning,
                                              False, seed=8, words=(21, -3), step="hmc",
                                              chain_block=block)
    assert not failures, res
    if tuning:
        assert float(got["window"]) == 202.0


@pytest.mark.cuda
@pytest.mark.parametrize("block", [8, 5, 1])
def test_fused_hmc_block_kernel_tune_chunk_as_the_cell_runs_it(hopper, block):
    """The tune chunk as HMC ``adapt_full`` runs it, on the block instance
    in blocks of 8, 5 and 1 chains: the step size adapting, ``adapt_dense``
    across the window swap; its first draw chain for chain, the
    dual-averaging state against its replay, the pooled Welford state
    against a float64 replay of the kernel's trace."""
    res, failures, got, _, _, _ = fused_check(tm.CorrelatedGaussian(100), 40 * block, 4, True,
                                              True, seed=10, words=(67, 19), step="hmc",
                                              chain_block=block)
    assert not failures, res
    assert res["step_size_adapting"] and "da_tol_share" in res
    assert float(got["window"]) == 202.0


@pytest.mark.cuda
@pytest.mark.parametrize("tuning", [False, True], ids=["draw_chunk", "tune_chunk"])
def test_fused_hmc_blocks_of_16_stay_on_the_warp_instance(hopper, tuning):
    """Chain blocks of 16 run the fused HMC kernel's warp instance
    (``fused_hmc<1,1>``), held as the block instance is."""
    from littlemcmc_torch.ops.nuts_trajectory import runs_hmc_block_transition

    assert not runs_hmc_block_transition("correlated_gaussian", "dense", 16, fused=True)
    res, failures, got, _, _, _ = fused_check(tm.CorrelatedGaussian(100), 256, 4, tuning,
                                              False, seed=8, words=(21, -3), step="hmc",
                                              chain_block=16)
    assert not failures, res
    if tuning:
        assert float(got["window"]) == 202.0


# Rows 4c and 4b: the fused HMC kernel's instances with the chain's state
# in registers (csrc/fused_hmc.cu). Body 4 with the low-rank metric in
# chain blocks of up to 8 at n <= 128 runs fused_hmc_lowrank_kernel (one
# warp a chain, every vector and both thin factors in registers); larger
# blocks and n keep the warp instance. Eight schools with the diagonal
# metric runs fused_hmc_packed_kernel at every chain block: several chains
# a warp, a thread block still the counter stream's chain block, so a
# block of 1 or 7 chains leaves part of a warp without a chain. Both give
# the warp instance's bits (scripts/torch_kernel_ab.py's digests, PERF.md);
# here each is held against the plain version.

@pytest.mark.cuda
@pytest.mark.parametrize("n,block", [(100, 1), (100, 7), (100, 8), (100, 16), (12, 8),
                                     (128, 8), (129, 8)])
@pytest.mark.parametrize("tuning", [False, True], ids=["draw_chunk", "tune_chunk"])
def test_fused_hmc_lowrank_register_instance_matches_plain(hopper, n, block, tuning):
    """The fused HMC kernel's low-rank branch on the spiked Gaussian at 32
    chain blocks: the register instance in blocks of 1, 7 and 8 and at n =
    12, 100 and 128, the warp instance in blocks of 16 and at n = 129; a
    4-draw draw chunk, and a 4-draw ``adapt_metric`` tune chunk with dual
    averaging (its first draw held chain for chain, the dual-averaging
    state against its replay, the Welford rows against a float64 replay of
    the kernel's trace)."""
    from littlemcmc_torch.ops.nuts_trajectory import fused_hmc_transition

    want = "registers" if block <= 8 and n <= 128 else "warp"
    assert fused_hmc_transition("spiked_gaussian", "lowrank", block, n) == want
    res, failures, _, _, _, _ = fused_check(tm.SpikedGaussian(n), 32 * block, 4, tuning, tuning,
                                            seed=31, words=(37, -5), step="hmc",
                                            metric="lowrank", chain_block=block)
    assert not failures, res
    assert res["accept_rate"] > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("block,chains", [(1, 37), (7, 259), (8, 256), (16, 512)])
@pytest.mark.parametrize("tuning", [False, True], ids=["draw_chunk", "tune_chunk"])
def test_fused_hmc_packed_instance_matches_plain(hopper, block, chains, tuning):
    """Eight schools' packed instance against the plain version in chain
    blocks of 1, 7, 8 and 16 (37 and 259 chains: blocks whose chains the
    packing does not divide, so a warp holds fewer chains than it has
    segments), a quarter of the chains in the funnel's neck: a 4-draw draw
    chunk, and a 4-draw ``adapt_metric`` tune chunk with dual averaging."""
    from littlemcmc_torch.ops._build import last_blocks_per_sm
    from littlemcmc_torch.ops.nuts_trajectory import fused_hmc_transition

    assert fused_hmc_transition("eight_schools", "diag", block, 10) == "packed"
    res, failures, got, _, _, _ = fused_check(tm.EightSchools(), chains, 4, tuning, tuning,
                                              seed=9, words=(23, -5), step="hmc",
                                              metric="diag", chain_block=block)
    assert not failures, res
    assert last_blocks_per_sm("fused_hmc") >= 1
    if tuning:
        assert (got["window"] == 100.0).all() and (got["n_samples"] == 52.0).all()


# ptxas's lines of the fused HMC kernel's instances before the register
# instances (registers, stack frame, spill stores, spill loads, as the
# sm_90a build printed them; PERF.md, rows 4b and 4c), keyed
# <body,metric,block>; <2,0,0>, the warp instance the packed one replaced,
# is no longer compiled
_FUSED_HMC_PTXAS = {
    "<0,0,0>": (64, 96, 0, 0), "<0,1,0>": (105, 96, 0, 0), "<0,2,0>": (127, 96, 0, 0),
    "<1,0,0>": (64, 136, 64, 72), "<1,1,0>": (106, 96, 0, 0), "<1,1,1>": (158, 32, 0, 0),
    "<1,2,0>": (123, 96, 0, 0), "<2,1,0>": (100, 96, 0, 0), "<2,2,0>": (127, 96, 0, 0),
    "<3,0,0>": (128, 96, 0, 0), "<3,1,0>": (128, 96, 0, 0), "<3,2,0>": (128, 96, 0, 0),
    "<4,0,0>": (126, 96, 0, 0), "<4,1,0>": (127, 96, 0, 0), "<4,2,0>": (128, 96, 0, 0),
    "<5,0,0>": (64, 96, 0, 0), "<5,1,0>": (102, 96, 0, 0), "<5,2,0>": (120, 96, 0, 0),
}


@pytest.mark.cuda
def test_fused_hmc_ptxas_lines(hopper):
    """The register instances (``fused_hmc_lowrank_kernel<4>``,
    ``fused_hmc_packed_kernel<2>``) spill nothing, and every other
    instance of ``fused_hmc.cu`` keeps the line it had before them."""
    import re

    from chip_smoke import _ptxas_entries
    from littlemcmc_torch.ops import _build

    log = (_build.build_all()["fused_hmc"].parent / "fused_hmc.log").read_text()
    got, new = {}, {}
    for entry, lines in _ptxas_entries(log).items():
        text = " ".join(lines)
        frame, stores, loads = map(int, re.search(
            r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
            text).groups())
        regs = int(re.search(r"Used (\d+) registers", text).group(1))
        m = re.search(r"fused_hmc_kernelILi(\d)ELi(\d)ELb(\d)E", entry)
        if m:
            got["<%s,%s,%s>" % m.groups()] = (regs, frame, stores, loads)
        m = re.search(r"fused_hmc_(lowrank|packed)_kernelILi(\d)E", entry)
        if m:
            new[m.group(1)] = (regs, frame, stores, loads)
    assert got == _FUSED_HMC_PTXAS
    assert set(new) == {"lowrank", "packed"}
    for kind, (regs, frame, stores, loads) in new.items():
        assert stores == 0 and loads == 0, (kind, regs, frame)


# --------------------------------------------------------------------------
# eight schools and the fused kernels' diag branch
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_eight_schools_kernels_match_plain(hopper):
    """The per-draw NUTS and HMC kernels with the eight-schools body chain
    for chain, 512 chains, a quarter of them deep in the funnel's neck: the
    checks of the smoke's phases 2f-2g."""
    from chip_smoke import _compare, _posterior_inputs

    es = tm.EightSchools()
    _compare("eight_schools", es, _posterior_inputs(es, 512, 0.3, seed=4), (5, -6), need=0.99)
    res, failures, _, _ = hmc_check(es, _hmc_inputs(es, None, 512, 0.25, 5), (7, 8), 0.99,
                                    scaled=True)
    assert not failures, res


@pytest.mark.cuda
@pytest.mark.parametrize("step", ["nuts", "hmc"])
@pytest.mark.parametrize("body", ["correlated_gaussian", "eight_schools"])
@pytest.mark.parametrize("tuning", [False, True], ids=["draw_chunk", "tune_chunk"])
def test_fused_diag_kernel_matches_plain(hopper, step, body, tuning):
    """The fused kernels' diag branch against the plain version at 256
    chains x 4 draws: a draw chunk, and a tune chunk with the per-chain
    Welford steps across a window swap and dual averaging on (its metric
    and Welford state against a float64 replay); the checks of the smoke's
    phases 2h-2i."""
    model = tm.CorrelatedGaussian(100) if body == "correlated_gaussian" else tm.EightSchools()
    res, failures, got, _, _, _ = fused_check(model, 256, 4, tuning, True, seed=9,
                                              words=(23, -5), step=step, metric="diag")
    assert not failures, res
    if tuning:
        assert (got["window"] == 100.0).all() and (got["n_samples"] == 52.0).all()


# Bodies 0 and 1 with the diagonal metric in blocks of up to 8 chains run
# the block transition (csrc/nuts_transition.cuh): body 1 evaluated for
# the block in one product, the merge stack's lower slots in shared memory.
# A step of 0.002 keeps every U-turn check of the correlated Gaussian (and
# of its one-dimensional case, half a period at 3.1) from firing before
# 1023 leaves: trees reach the depth cap of 10, which writes every slot of
# the stack. At n = 256 the nine slots do not all fit beside the working
# states (three per-draw, two fused in shared memory, the rest in global
# memory): merges cross the boundary.
#
# At depth 10 a chain-draw makes about 1000 multinomial choices, each
# comparing log(u) with a difference of log weights that the kernel and the
# plain version round apart (the body's sums in another order); a choice
# that falls within that rounding of u takes the other proposal while the
# tree, and so the flags, stay the same. The block transition gives the
# same bits as the warp transition it replaces (scripts/torch_kernel_ab.py's
# output digests, PERF.md), so such a flip is the plain version's rounding: the proposals
# and energies are held on all but _FLIPS of the held chain-draws.
_BLOCK_BODY_NS = [1, 31, 32, 33, 100, 256]
_FLIPS = 0.03


def _flip_share(got, want, held, sd, q_key):
    """The share of held chain-draws whose proposal (``q_key``: ``q`` of
    one transition, ``trace`` of a fused chunk) or energy is off by more
    than the tolerances (1e-4 posterior sd, 1e-3)."""
    dq = ((got[q_key] - want[q_key]).abs() / sd).amax(-1)
    de = (got["energy"] - want["energy"]).abs()
    return float(((dq > 1e-4) | (de > 1e-3))[held].float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("n", _BLOCK_BODY_NS)
def test_block_body_kernel_to_depth_10_matches_plain(hopper, n):
    model = tm.CorrelatedGaussian(n)
    D = 10
    args = _inputs(model, np.linalg.cholesky(model.cov), 128, D, 0.002, 13, hopper)
    kw = dict(spec=model.trajectory_spec(), max_treedepth=D, Emax=1000.0, chain_block=8)
    got = trajectory(*args, (31, -37), **kw)
    torch.cuda.synchronize()
    want = trajectory_plain(*args, (31, -37), **kw)
    assert int(want["depth"].max()) == D
    assert float((want["depth"] == D).float().mean()) > 0.5
    agree = torch.stack([got[k] == want[k] for k in FLAGS]).all(0)
    assert float(agree.float().mean()) >= 0.99
    sd = torch.from_numpy(np.sqrt(model.true_var)).float().to(hopper)
    assert _flip_share(got, want, agree, sd, "q") <= _FLIPS


@pytest.mark.cuda
@pytest.mark.parametrize("n,tuning", [(n, False) for n in _BLOCK_BODY_NS]
                         + [(33, True), (256, True)],
                         ids=[f"draw_chunk-{n}" for n in _BLOCK_BODY_NS] + ["tune_chunk-33",
                                                                          "tune_chunk-256"])
def test_fused_block_body_kernel_to_depth_10_matches_plain(hopper, n, tuning):
    """The fused kernel's body-1 diag instance, 2 draws of 64 chains at step
    0.002 (the step held, so both draws reach depth 10): a draw chunk at
    each n, and a tune chunk with the per-chain Welford steps across a
    window swap on either side of 128 columns; the checks of the smoke's
    phases 2h-2i, but for the proposals, energies and log densities that a
    flipped choice moves (and in a tune chunk the Welford state against the
    plain version, which follows the plain version's proposals): those on
    all but _FLIPS of the held chain-draws, the Welford state against a
    float64 replay of the kernel's own trace."""
    model = tm.CorrelatedGaussian(n)
    res, failures, got, want, _, _ = fused_check(model, 64, 2, tuning, False, seed=15,
                                                 words=(41, -43), metric="diag",
                                                 log_step=float(np.log(0.002)))
    moved = ("q or energy differ", "stat model_logp", "stat energy_error")
    assert not [f for f in failures if not f.startswith(moved)
                and "against the plain version" not in f], res
    assert int(want["depth"].max()) == 10 and res["mean_depth"] > 5
    agree = torch.stack([got[k] == want[k] for k in FLAGS]).all(0)
    held = _held(agree)
    sd = torch.from_numpy(np.sqrt(model.true_var)).float().to(hopper)
    assert _flip_share(got, want, held, sd, "trace") <= _FLIPS, res


# Body 1 with the dense metric in blocks of up to 8 chains runs the block
# transition too: the drift's and the energy's velocities p COV as
# block-wide products like the body's, each leaf's energy velocity cached
# beside its momentum in the merge stack (6 vectors a slot) and the tree's
# edges, so that the merges and U-turn checks do no product. With the true
# covariance as the metric the dynamics turn with period 2 pi: at a step of
# 0.002 no U-turn fires before 1023 leaves, so trees reach the depth cap
# of 10 and write every slot of the stack (the lower ones in shared
# memory, from slot 4 at n = 100 and slot 1 at n = 256 in the global
# stack's 6-vector layout; at n = 256 P and COV stay in global memory
# too). Blocks of 1 and 5 chains take the block transition's ragged
# products (a chain group of 4 with 3 or 1 empty places); blocks of 16 stay
# on the warp transition.
@pytest.mark.cuda
@pytest.mark.parametrize("n,chains,block", [(100, 64, 8), (100, 40, 5), (100, 16, 1),
                                            (256, 64, 8), (33, 64, 8), (100, 64, 16)])
def test_dense_block_kernel_to_depth_10_matches_plain(hopper, n, chains, block):
    from littlemcmc_torch.ops.nuts_trajectory import runs_block_transition

    model = tm.CorrelatedGaussian(n)
    assert runs_block_transition("correlated_gaussian", "dense", block) == (block <= 8)
    D = 10
    args = _dense_inputs(model, chains, D, 0.002, 13, hopper)
    kw = dict(spec=model.trajectory_spec(), max_treedepth=D, Emax=1000.0, chain_block=block,
              metric="dense")
    launches = trajectory.launches
    got = trajectory(*args, (31, -37), **kw)
    torch.cuda.synchronize()
    assert trajectory.launches == launches + 1
    want = trajectory_plain(*args, (31, -37), **kw)
    assert int(want["depth"].max()) == D
    assert float((want["depth"] == D).float().mean()) > 0.5
    agree = torch.stack([got[k] == want[k] for k in FLAGS]).all(0)
    assert float(agree.float().mean()) >= 0.99
    sd = torch.from_numpy(np.sqrt(model.true_var)).float().to(hopper)
    assert _flip_share(got, want, agree, sd, "q") <= _FLIPS


@pytest.mark.cuda
@pytest.mark.parametrize("n,chains,block,tuning,adapt_step_size", [
    (100, 64, 8, False, False), (100, 40, 5, False, False), (100, 16, 1, False, False),
    (256, 64, 8, False, False), (100, 64, 8, True, False), (256, 64, 8, True, False),
], ids=["draw-100-8", "draw-100-5", "draw-100-1", "draw-256-8", "tune-100-8", "tune-256-8"])
def test_fused_dense_block_kernel_to_depth_10_matches_plain(hopper, n, chains, block, tuning,
                                                            adapt_step_size):
    """The fused kernel's body-1 dense instance on the block transition, 3
    draws at step 0.002 (held, so every draw reaches depth 10): a draw
    chunk at n = 100 in blocks of 8, 5 and 1 chains and at n = 256 (P, COV
    and L^-1 in global memory), and an ``adapt_dense`` tune chunk across
    the window swap at draw 2; the checks of the smoke's phase 2c, but for
    the proposals, energies and log densities that a flipped choice moves:
    those on all but _FLIPS of the held chain-draws, the pooled Welford
    state against a float64 replay of the kernel's own trace."""
    model = tm.CorrelatedGaussian(n)
    res, failures, got, want, _, _ = fused_check(
        model, chains, 3, tuning, adapt_step_size, seed=15, words=(41, -43),
        dense_log_step=float(np.log(0.002)), chain_block=block)
    moved = ("q or energy differ", "stat model_logp", "stat energy_error")
    assert not [f for f in failures if not f.startswith(moved)
                and "against the plain version" not in f], res
    assert int(want["depth"].max()) == 10 and res["mean_depth"] > 5
    agree = torch.stack([got[k] == want[k] for k in FLAGS]).all(0)
    held = _held(agree, block)
    sd = torch.from_numpy(np.sqrt(model.true_var)).float().to(hopper)
    assert _flip_share(got, want, held, sd, "trace") <= _FLIPS, res
    if tuning:
        assert float(got["window"]) == 202.0


@pytest.mark.cuda
@pytest.mark.parametrize("block", [8, 5, 1])
def test_fused_dense_block_kernel_tune_chunk_as_the_cell_runs_it(hopper, block):
    """The tune chunk as ``adapt_full`` runs it, on the block transition in
    blocks of 8, 5 and 1 chains: the step size adapting from about 0.5
    (a quarter of the trees diverge, so divergent leaves, which are neither
    merged nor stored, are among those held) and ``adapt_dense`` across the
    window swap; the first draw tree for tree, the dual-averaging state
    against its replay, the pooled Welford state against a float64 replay
    of the kernel's trace (the checks of the smoke's phase 2c)."""
    res, failures, got, _, _, _ = fused_check(tm.CorrelatedGaussian(100), 40 * block, 4,
                                              True, True, seed=5, words=(47, 13),
                                              chain_block=block)
    assert not failures, res
    assert res["step_size_adapting"] and "da_tol_share" in res
    assert res["divergence_share"] > 0.05
    assert float(got["window"]) == 202.0


# Bodies 4 (the spiked Gaussian) and 5 (Neal's centred funnel) with the
# diagonal metric in blocks of up to 8 chains run the block transition too,
# each evaluated inside the leapfrog's two passes. At a step of 0.002 the
# spiked Gaussian's trees reach the depth cap of 10 on every chain without
# the early cap (every stack slot written; at n = 256 the upper slots in
# global memory), at k = 1, 4 and 8 spikes (the `rows` of the body's thin
# dots). The funnel's positions put a quarter of the chains in the neck
# (v in [-6, -2]): at 0.002 the chains in the mouth reach depth 10, at 0.2
# a third of them diverge, at 1.0 nearly all do and some trajectories'
# energies turn non-finite in the neck (exp(-v) overflows), so the
# divergence and non-finite branches are held against the plain version.
_SPIKES = (400.0, 100.0, 25.0, 9.0, 4.0, 3.0, 2.0, 1.5)


def _spiked(n, k):
    return tm.SpikedGaussian(n, rank=k, spikes=_SPIKES[:k])


def _posterior_like_inputs(model, C, D, eps, seed, dev):
    """:func:`_inputs` for a model without a covariance matrix: positions
    spread like its posterior (``chip_smoke._positions``), an inverse-mass
    diagonal near its posterior variances."""
    rng = np.random.default_rng(seed)
    n = model.ndim
    q = torch.from_numpy(_positions(model, rng, C)).to(dev)
    var = (_posterior_sd(model) ** 2 * rng.uniform(0.5, 2.0, (C, n))).astype(np.float32)
    p = (rng.standard_normal((C, n)) / np.sqrt(var)).astype(np.float32)
    eps = (eps * rng.uniform(0.8, 1.2, C)).astype(np.float32)
    mdc = np.full(C, D, np.int32)
    mdc[::5] = D - 2  # some chains carry the early tree-depth cap
    logp, grad = model.batched_logp_grad(q)
    return (q, torch.from_numpy(p).to(dev), grad.contiguous(), logp.contiguous(),
            torch.from_numpy(eps).to(dev), torch.from_numpy(mdc).to(dev),
            torch.from_numpy(var).to(dev))


def _block_body_4_5_check(model, chains, eps, seed, dev):
    """One launch of the per-draw kernel against its plain version: the
    flags on at least 99% of chains, the proposals and energies on all but
    _FLIPS of those. Returns the plain version's outputs."""
    D = 10
    args = _posterior_like_inputs(model, chains, D, eps, seed, dev)
    kw = dict(spec=model.trajectory_spec(), max_treedepth=D, Emax=1000.0, chain_block=8)
    launches = trajectory.launches
    got = trajectory(*args, (31, -37), **kw)
    torch.cuda.synchronize()
    assert trajectory.launches == launches + 1
    want = trajectory_plain(*args, (31, -37), **kw)
    agree = torch.stack([got[k] == want[k] for k in FLAGS]).all(0)
    assert float(agree.float().mean()) >= 0.99
    sd = torch.from_numpy(_posterior_sd(model)).float().to(dev)
    assert _flip_share(got, want, agree, sd, "q") <= _FLIPS
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(100, 1), (100, 4), (100, 8), (256, 4)])
def test_block_spiked_kernel_to_depth_10_matches_plain(hopper, n, k):
    want = _block_body_4_5_check(_spiked(n, k), 128, 0.002, 13, hopper)
    assert int(want["depth"].max()) == 10
    assert float((want["depth"] == 10).float().mean()) > 0.75


@pytest.mark.cuda
@pytest.mark.parametrize("eps", [0.002, 0.2, 1.0])
def test_block_funnel_kernel_matches_plain(hopper, eps):
    want = _block_body_4_5_check(tm.NealsFunnel(10), 256, eps, 17, hopper)
    if eps == 0.002:
        assert int(want["depth"].max()) == 10
    else:
        assert float(want["diverging"].float().mean()) > 0.3
    if eps == 1.0:
        assert not torch.isfinite(want["max_energy_change"]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("body,n,k,tuning,log_step", [
    ("spiked", 100, 4, False, float(np.log(0.002))),
    ("spiked", 256, 8, False, float(np.log(0.002))),
    ("spiked", 100, 1, True, float(np.log(0.002))),
    ("funnel", 10, 0, False, float(np.log(0.002))),
    ("funnel", 10, 0, False, -1.2),
    ("funnel", 10, 0, True, -1.2),
], ids=["spiked-100-4-draw", "spiked-256-8-draw", "spiked-100-1-tune", "funnel-depth-10",
        "funnel-draw", "funnel-tune"])
def test_fused_block_spiked_and_funnel_kernel_matches_plain(hopper, body, n, k, tuning,
                                                            log_step):
    """The fused kernel's body-4 and body-5 diag instances, 2 draws of 64
    chains (256 for the funnel at its step near 0.3, where a third of its
    chains diverge): at step 0.002 as the body-1 test above holds them; at
    the funnel's larger step every check of the smoke's phase 2p."""
    model = _spiked(n, k) if body == "spiked" else tm.NealsFunnel(n)
    deep = log_step < -5.0
    res, failures, got, want, _, _ = fused_check(model, 64 if deep else 256, 2, tuning, False,
                                                 seed=15, words=(41, -43), metric="diag",
                                                 log_step=log_step)
    if not deep:
        assert not failures, res
        assert float(want["diverging"].float().mean()) > 0.1
        return
    moved = ("q or energy differ", "stat model_logp", "stat energy_error")
    assert not [f for f in failures if not f.startswith(moved)
                and "against the plain version" not in f], res
    assert int(want["depth"].max()) == 10
    agree = torch.stack([got[k_] == want[k_] for k_ in FLAGS]).all(0)
    held = _held(agree)
    sd = torch.from_numpy(_posterior_sd(model)).float().to(hopper)
    assert _flip_share(got, want, held, sd, "trace") <= _FLIPS, res


# Body 4 with the pooled low-rank metric in blocks of up to 8 chains (every
# block the low-rank metric takes) runs the block transition: the drift's
# and the energy's velocities computed inside the leapfrog's passes, each
# leaf's energy velocity cached beside its momentum in the merge stack (6
# vectors a slot) and the tree's edges, so that the merges and U-turn
# checks compute no velocity. With the model's own spikes as the factor
# block (the bulk 1 exact) and the scales off by up to 25%, or its
# variances off by up to a factor 2 in the fused op, no U-turn fires before
# 1023 leaves at a step of 0.002: trees reach the depth cap of 10 and
# write every slot of the stack (at n = 256 the upper ones in the global
# stack's 6-vector layout). Blocks of 5, 3 and 1 chains leave the block
# ragged; k = 4 and 8 spikes fill half and all of the factor's columns.
# The plain versions step their blocks one after another, so every case
# runs 8 blocks.
@pytest.mark.cuda
@pytest.mark.parametrize("n,k,chains,block", [(100, 4, 64, 8), (100, 8, 64, 8), (100, 4, 40, 5),
                                              (100, 8, 8, 1), (256, 8, 64, 8), (33, 4, 24, 3)],
                         ids=["100-4-8", "100-8-8", "100-4-5", "100-8-1", "256-8-8", "33-4-3"])
def test_lowrank_block_kernel_to_depth_10_matches_plain(hopper, n, k, chains, block):
    from chip_smoke import _lowrank_inputs
    from littlemcmc_torch.ops.nuts_trajectory import runs_block_transition

    model = _spiked(n, k)
    assert runs_block_transition("spiked_gaussian", "lowrank", block)
    D = 10
    args, fac = _lowrank_inputs(model, chains, 0.002, seed=13)
    mdc = args[5].clone()
    mdc[::5] = D - 2  # some chains carry the early tree-depth cap
    args = args[:5] + (mdc, args[6])
    kw = dict(spec=model.trajectory_spec(), max_treedepth=D, Emax=1000.0, chain_block=block,
              metric="lowrank", fac=fac)
    launches = trajectory.launches
    got = trajectory(*args, (31, -37), **kw)
    torch.cuda.synchronize()
    assert trajectory.launches == launches + 1
    want = trajectory_plain(*args, (31, -37), **kw)
    assert int(want["depth"].max()) == D
    assert float((want["depth"] == D).float().mean()) > 0.5
    agree = torch.stack([got[k_] == want[k_] for k_ in FLAGS]).all(0)
    assert float(agree.float().mean()) >= 0.99
    sd = torch.from_numpy(_posterior_sd(model)).float().to(hopper)
    assert _flip_share(got, want, agree, sd, "q") <= _FLIPS


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,chains,block,tuning", [
    (100, 4, 64, 8, False), (100, 8, 64, 8, False), (100, 4, 40, 5, False),
    (100, 8, 8, 1, False), (256, 8, 64, 8, False), (100, 4, 64, 8, True),
    (100, 8, 24, 3, True),
], ids=["draw-100-4-8", "draw-100-8-8", "draw-100-4-5", "draw-100-8-1", "draw-256-8-8",
        "tune-100-4-8", "tune-100-8-3"])
def test_fused_lowrank_block_kernel_to_depth_10_matches_plain(hopper, n, k, chains, block,
                                                              tuning):
    """The fused kernel's body-4 low-rank instance on the block transition
    (its momenta and start velocities in the block's passes too), 2 draws
    at step 0.002 (held, so both draws reach depth 10): draw chunks in
    blocks of 8, 5 and 1 chains and at n = 256, tune chunks with the
    per-chain Welford steps across a window swap; the checks of the
    smoke's phase 2n, but for the proposals, energies and log densities
    that a flipped choice moves (and the Welford state against the plain
    version, which follows its proposals): those on all but _FLIPS of the
    held chain-draws, the Welford state against a float64 replay of the
    kernel's own trace."""
    model = _spiked(n, k)
    res, failures, got, want, _, _ = fused_check(model, chains, 2, tuning, False, seed=15,
                                                 words=(41, -43), metric="lowrank",
                                                 log_step=float(np.log(0.002)),
                                                 chain_block=block)
    moved = ("q or energy differ", "stat model_logp", "stat energy_error")
    assert not [f for f in failures if not f.startswith(moved)
                and "against the plain version" not in f], res
    assert int(want["depth"].max()) == 10 and res["mean_depth"] > 5
    agree = torch.stack([got[k_] == want[k_] for k_ in FLAGS]).all(0)
    held = _held(agree, block)
    sd = torch.from_numpy(_posterior_sd(model)).float().to(hopper)
    assert _flip_share(got, want, held, sd, "trace") <= _FLIPS, res


@pytest.mark.cuda
def test_lowrank_block_kernel_refuses_where_the_spikes_do_not_fit(hopper):
    """Body 4 with the low-rank metric has no warp transition: where its
    constants do not fit in shared memory beside the working vectors (n =
    390 in blocks of 8: 17 vectors of 8 chains, the factor block and 8
    spikes of 390), the per-draw launch is refused, never run elsewhere."""
    from chip_smoke import _lowrank_inputs

    model = _spiked(390, 8)
    args, fac = _lowrank_inputs(model, 8, 0.1, seed=3)
    with pytest.raises(RuntimeError, match="launch failed"):
        trajectory(*args, (3, 5), spec=model.trajectory_spec(), max_treedepth=10, Emax=1000.0,
                   chain_block=8, metric="lowrank", fac=fac)
    got = trajectory(*args, (3, 5), spec=model.trajectory_spec(), max_treedepth=10,
                     Emax=1000.0, chain_block=4, metric="lowrank", fac=fac)
    assert torch.isfinite(got["q"]).all()


# Body 2 (eight schools, n = 10) with the diagonal metric in blocks of up
# to 8 chains runs the block transition too, in instances of its own
# compiled for several blocks an SM (the cells' 10,240 chains make 1,280
# blocks of 8): the body evaluated inside the leapfrog's passes, each
# lane's column and its two constants in registers, the whole merge stack
# in shared memory. The inputs put a quarter of the chains deep in the
# funnel's neck (chip_smoke._es_positions); at a step of 0.002 three
# quarters of the trees reach the depth cap of 10 (every slot of the
# stack written), a few U-turn early. Blocks of 5 and 1 chains leave the
# block ragged; blocks of 16 stay on the warp transition.
@pytest.mark.cuda
@pytest.mark.parametrize("chains,block", [(64, 8), (40, 5), (8, 1), (64, 16)],
                         ids=["8", "5", "1", "16-warp"])
def test_es_block_kernel_to_depth_10_matches_plain(hopper, chains, block):
    from littlemcmc_torch.ops.nuts_trajectory import runs_block_transition

    es = tm.EightSchools()
    assert runs_block_transition("eight_schools", "diag", block) == (block <= 8)
    D = 10
    args = _posterior_like_inputs(es, chains, D, 0.002, 13, hopper)
    kw = dict(spec=es.trajectory_spec(), max_treedepth=D, Emax=1000.0, chain_block=block)
    launches = trajectory.launches
    got = trajectory(*args, (31, -37), **kw)
    torch.cuda.synchronize()
    assert trajectory.launches == launches + 1
    want = trajectory_plain(*args, (31, -37), **kw)
    assert int(want["depth"].max()) == D
    assert float((want["depth"] == D).float().mean()) > 0.5
    agree = torch.stack([got[k] == want[k] for k in FLAGS]).all(0)
    assert float(agree.float().mean()) >= 0.99
    sd = torch.from_numpy(_posterior_sd(es)).float().to(hopper)
    assert _flip_share(got, want, agree, sd, "q") <= _FLIPS


@pytest.mark.cuda
@pytest.mark.parametrize("block,tuning", [(8, False), (5, False), (1, False), (8, True),
                                          (5, True), (1, True)],
                         ids=["draw-8", "draw-5", "draw-1", "tune-8", "tune-5", "tune-1"])
def test_fused_es_block_kernel_matches_plain(hopper, block, tuning):
    """The fused kernel's body-2 diag instance on the block transition, in
    blocks of 8, 5 and 1 chains: a 2-draw draw chunk of 8 blocks at step
    0.002 (held, so the trees reach depth 10), as the body-1 test above
    holds it; and a 4-draw tune chunk of 40 blocks as the cell's first
    chunk runs it (the per-chain Welford steps across a window swap, the
    step size adapting from about 0.3, where 40% of the trees diverge, so
    divergent leaves are among those held) with every check of the smoke's
    phase 2i."""
    es = tm.EightSchools()
    if tuning:
        res, failures, got, _, _, _ = fused_check(es, 40 * block, 4, True, True, seed=15,
                                                  words=(41, -43), metric="diag",
                                                  chain_block=block)
        assert not failures, res
        assert res["step_size_adapting"] and res["divergence_share"] > 0.1
        return
    res, failures, got, want, _, _ = fused_check(es, 8 * block, 2, False, False, seed=15,
                                                 words=(41, -43), metric="diag",
                                                 log_step=float(np.log(0.002)),
                                                 chain_block=block)
    moved = ("q or energy differ", "stat model_logp", "stat energy_error")
    assert not [f for f in failures if not f.startswith(moved)
                and "against the plain version" not in f], res
    assert int(want["depth"].max()) == 10 and res["mean_depth"] > 5
    agree = torch.stack([got[k] == want[k] for k in FLAGS]).all(0)
    held = _held(agree, block)
    sd = torch.from_numpy(_posterior_sd(es)).float().to(hopper)
    assert _flip_share(got, want, held, sd, "trace") <= _FLIPS, res


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["trajectory", "fused_nuts"])
def test_es_block_kernels_at_the_cells_10240_chains(hopper, kernel):
    """One launch of each eight-schools block instance at the cells' 10,240
    chains (1,280 blocks, several sharing an SM: the launch's blocks an SM
    from the runtime's occupancy), held against the plain version on every
    sixteenth chain (whole blocks, a quarter of them in the neck): the
    per-draw launch as the smoke's phase 2f checks it, a 2-draw tune chunk
    as phase 2i does."""
    from chip_smoke import _compare, _posterior_inputs
    from littlemcmc_torch.ops._build import last_blocks_per_sm

    es = tm.EightSchools()
    if kernel == "trajectory":
        _compare("eight_schools", es, _posterior_inputs(es, 10240, 0.3, seed=4), (5, -6),
                 need=0.99, share=16)
        name = "nuts_trajectory"
    else:
        res, failures, _, _, _, _ = fused_check(es, 10240, 2, True, True, seed=9,
                                                words=(23, -5), metric="diag", share=16)
        assert not failures, res
        name = "fused_nuts"
    assert last_blocks_per_sm(name) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("step", ["nuts", "hmc"])
def test_eight_schools_sample_on_the_card(hopper, step):
    """Eight schools at 1024 chains, 250 + 250, target_accept 0.95, on the
    fused diag engine: two launches of the fused kernel, mu and log_tau
    within 0.2 posterior sd of the exact means."""
    model = tm.EightSchools()
    report = {}
    es_step = (HamiltonianMC(model_ndim=10, target_accept=0.95) if step == "hmc"
               else NUTS(model_ndim=10, target_accept=0.95))
    trace, stats = sample(model.logp_grad, model_ndim=10, chains=1024, tune=250, draws=250,
                          random_seed=3, step=es_step, perf_report=report, progressbar=False)
    name = "fused_nuts" if step == "nuts" else "fused_hmc"
    assert report["engine"] == "fused_diag" and report["trajectory"] == "cuda"
    assert report["kernel_launches"][name] == 2 and sum(report["kernel_launches"].values()) == 2
    assert trace.shape == (1024, 250, 10) and np.isfinite(trace).all()
    assert stats["diverging"].mean() < 0.03
    exact = model.exact_moments()
    for i, k in enumerate(("mu", "log_tau")):
        assert abs(trace[:, :, i].mean() - exact[k][0]) < 0.2 * exact[k][1], k


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["trajectory", "hmc_trajectory", "fused_nuts", "fused_hmc"])
def test_kernels_refuse_an_unknown_body(hopper, monkeypatch, kernel):
    """A body id no kernel was compiled for is refused at launch (CUDA's
    invalid-argument error, raised by the wrapper), never run as another
    body."""
    from littlemcmc_torch.base import HMCConfig, NUTSConfig
    from littlemcmc_torch.ops import fused_hmc, fused_nuts, hmc_trajectory
    from littlemcmc_torch.ops.nuts_trajectory import BODY_IDS

    model = tm.StandardNormal(4)
    monkeypatch.setitem(BODY_IDS, "standard_normal", 3)
    q = torch.zeros(64, 4, device=hopper)
    c = torch.zeros(64, device=hopper)
    spec = model.trajectory_spec()
    launches = {"trajectory": lambda: trajectory(
                    q, q, q, c, c + 0.1, torch.full((64,), 3, dtype=torch.int32, device=hopper),
                    q + 1.0, 1, spec=spec, max_treedepth=3, Emax=1000.0),
                "hmc_trajectory": lambda: hmc_trajectory.hmc_trajectory(
                    q, q, q, c, c + 0.1, torch.ones(64, dtype=torch.int32, device=hopper),
                    q + 1.0, 1, spec=spec, Emax=1000.0),
                "fused_nuts": lambda: fused_nuts.fused_nuts(
                    q, q, c, c, c, c, c, c + 1, c, q + 1.0, None, (1, 2), spec=spec, T=1,
                    tuning=False, config=NUTSConfig(max_treedepth=3), metric="diag"),
                "fused_hmc": lambda: fused_hmc.fused_hmc(
                    q, q, c, c, c, c, c, c + 1, c, q + 1.0, None, (1, 2), spec=spec, T=1,
                    tuning=False, config=HMCConfig(), metric="diag")}
    with pytest.raises(RuntimeError, match="launch failed"):
        launches[kernel]()


# --------------------------------------------------------------------------
# the batched model kernels and the logistic body
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kind,chains,n,rows", [
    ("logistic", 5, 10, 300),
    ("logistic", 1024, 25, 1000),
    ("logistic", 37, 40, 129),
    # chains not a multiple of the chain tile; rows and n odd, so y starts
    # off a 16-byte boundary and the last row tile is ragged
    ("logistic", 1023, 25, 1000),
    ("logistic", 129, 25, 1001),
    ("logistic", 64, 26, 333),  # n even: the pad column
    ("logistic", 40, 256, 1000),  # n = 256: 64-row tiles cycling through 3 stages
    ("logistic", 77, 150, 700),  # 128-row tiles
    ("logistic", 33, 25, 5000),  # 20 row tiles of 256 cycling through 4 stages
    ("quadform", 5, 7, 0),
    ("quadform", 1024, 100, 0),
    ("quadform", 19, 33, 0),
    ("quadform", 1023, 100, 0),
    ("quadform", 129, 64, 0),
    ("quadform", 70, 256, 0),  # n = 256: 8 tiles of the precision through 6 stages
    # 3, 5, 6 and 7 column slots a lane
    ("quadform", 33, 80, 0),
    ("quadform", 24, 150, 0),
    ("quadform", 17, 190, 0),
    ("quadform", 9, 200, 0),
])
def test_model_kernels_match_plain(hopper, kind, chains, n, rows):
    """Rows 6 (logistic) and 5 (quadform) against their plain versions at
    odd sizes, where the tiles' edges fall inside a chain block, a row
    tile or a warp's columns, and at the paths' widths: the checks of the
    smoke's phase 2j (``tests/test_ops.py``'s tolerances)."""
    from chip_smoke import model_kernel_check

    res, failures, _ = model_kernel_check(kind, chains, n, rows, seed=chains)
    assert not failures, res


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["logistic", "quadform"])
def test_model_kernels_repeat_to_the_bit(hopper, kind):
    """Two launches on the same inputs give the same bits: every sum of
    rows 5 and 6 runs in a fixed order (no atomics)."""
    from chip_smoke import model_kernel_check

    _, failures, (kernel, _, _) = model_kernel_check(kind, 1023, 25 if kind == "logistic"
                                                     else 100, 1001, seed=4)
    assert not failures
    first, second = kernel(), kernel()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _unaligned(x):
    """``x``'s values in a view that starts 4 bytes past a 16-byte
    boundary."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    flat.copy_(x.reshape(-1))
    return flat.view(x.shape)


@pytest.mark.cuda
def test_model_kernels_take_unaligned_inputs(hopper):
    """q and the constants off 16-byte alignment: the quadform kernel
    loads such a q plainly, and both wrappers copy misaligned constants
    before the TMA reads them; results as the plain versions', with
    ``tests/test_ops.py``'s tolerances."""
    from littlemcmc_torch.ops.logistic import (logistic_logp_grad, logistic_logp_grad_plain,
                                               pack_logistic)
    from littlemcmc_torch.ops.quadform import quadform_logp_grad, quadform_logp_grad_plain

    rng = np.random.default_rng(8)
    gm = tm.CorrelatedGaussian(37)
    q = _unaligned(torch.from_numpy(rng.standard_normal((45, 37)).astype(np.float32))
                   .to(hopper))
    assert q.data_ptr() % 16 != 0
    for got, want in zip(quadform_logp_grad(q, _unaligned(gm.prec_f32)),
                         quadform_logp_grad_plain(q, gm.prec_f32)):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-4)
    lg = tm.LogisticRegression(*tm.german_credit_synthetic(301, 8))
    q = _unaligned(torch.from_numpy(0.3 * rng.standard_normal((45, 9)).astype(np.float32))
                   .to(hopper))
    packed = _unaligned(pack_logistic(lg.Xb, lg.y, lg.prior_prec))
    got = logistic_logp_grad(q, lg.Xb, lg.y, lg.prior_prec, packed=packed)
    want = logistic_logp_grad_plain(q, lg.Xb, lg.y, lg.prior_prec)
    torch.testing.assert_close(got[0], want[0], rtol=3e-4, atol=1e-2)
    torch.testing.assert_close(got[1], want[1], rtol=3e-4, atol=1e-3)


@pytest.mark.cuda
def test_logistic_body_in_the_trajectory_kernels_matches_plain(hopper):
    """The logistic body (3) in the per-draw NUTS kernel (512 chains) and
    the HMC kernel (256 chains) against their plain versions: the smoke's
    phases 2k and 2l (the HMC energies held relative to the energy change,
    ``scaled``: some of these trajectories end far from their start)."""
    from chip_smoke import _compare, _posterior_inputs

    lg = tm.LogisticRegression()
    _compare("logistic", lg, _posterior_inputs(lg, 512, 0.25, seed=21), (3, -5), need=0.99)
    res, failures, _, _ = hmc_check(lg, _hmc_inputs(lg, None, 256, 0.25, 22), (7, 11), 0.99,
                                    scaled=True)
    assert not failures, res


@pytest.mark.cuda
@pytest.mark.parametrize("step", ["nuts", "hmc"])
@pytest.mark.parametrize("tuning", [False, True], ids=["draw_chunk", "tune_chunk"])
def test_fused_logistic_kernel_matches_plain(hopper, step, tuning):
    """The logistic body in the fused kernels' diag branch against the
    plain version at 256 chains x 2 draws: a draw chunk, and a tune chunk
    with the per-chain Welford steps across a window swap and dual
    averaging on (the smoke's phase 2l runs the draw chunk)."""
    res, failures, _, _, _, _ = fused_check(tm.LogisticRegression(), 256, 2, tuning, True,
                                            seed=12, words=(29, -3), step=step, metric="diag")
    assert not failures, res


@pytest.mark.cuda
@pytest.mark.parametrize("n,rows,chains", [(40, 1000, 128), (256, 1000, 64), (25, 1001, 128),
                                           (25, 5000, 64)],
                         ids=["two_chunks", "eight_chunks", "rows_1001", "rows_5000"])
def test_logistic_body_beyond_the_main_shape_matches_plain(hopper, n, rows, chains):
    """The logistic body (3) past BASELINE config 4's 1000 x 25 design, in
    all four kernels against their plain versions: n = 40 (two gradient
    chunks in the per-draw kernels' 32-column tile, more in the fused
    kernels' narrower ones, reduced after every row block), n = 256, 1001
    rows (a last row block that lanes leave early) and 5000 rows (a
    500 KB design, read through L2 where the others sit in shared memory).
    The designs' features are independent standard normals (responses
    from a logistic model of logits about 1.5 in sd), so each posterior is
    near spherical and the smoke's step sizes hold; positions from its
    Laplace approximation (``chip_smoke._logistic_moments``). The checks
    and tolerances of the smoke's phases 2k-2l."""
    from chip_smoke import _compare, _posterior_inputs

    rng = np.random.RandomState(n + rows)
    X = rng.standard_normal((rows, n - 1))
    beta = rng.standard_normal(n - 1) * 1.5 / np.sqrt(n - 1)
    y = (rng.uniform(size=rows) < 1.0 / (1.0 + np.exp(-(X @ beta)))).astype(np.float64)
    model = tm.LogisticRegression(X, y)
    _compare("logistic", model, _posterior_inputs(model, chains, 0.25, seed=n), (n, rows),
             need=0.99)
    res, failures, _, _ = hmc_check(model, _hmc_inputs(model, None, chains, 0.25, n + 1),
                                    (rows, n), 0.99, scaled=True)
    assert not failures, res
    for step in ("nuts", "hmc"):
        res, failures, _, _, _, _ = fused_check(model, 64, 2, False, True, seed=n + 2,
                                                words=(n, -rows), step=step, metric="diag")
        assert not failures, res


@pytest.mark.cuda
def test_logistic_kernel_raises_rather_than_falling_back(hopper, monkeypatch):
    """``LogisticRegression(use_kernel=True).batched_logp_grad`` on CUDA
    tensors launches the kernel; when its build fails it raises and never
    runs the plain version."""
    from littlemcmc_torch.ops import _build, logistic

    model = tm.LogisticRegression(use_kernel=True)
    q = torch.zeros(16, model.ndim, device=hopper)
    launches = logistic.logistic_logp_grad.launches
    logp, grad = model.batched_logp_grad(q)
    torch.cuda.synchronize()
    assert logistic.logistic_logp_grad.launches == launches + 1
    assert logp.is_cuda and grad.shape == (16, model.ndim)

    def fail(*a, **k):
        raise AssertionError("the plain version ran")

    def no_build(name="nuts_trajectory"):
        raise RuntimeError("nvcc failed to build: (made to fail)")

    monkeypatch.setattr(logistic, "logistic_logp_grad_plain", fail)
    monkeypatch.setattr(_build, "load_library", no_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        model.batched_logp_grad(q)
    assert logistic.logistic_logp_grad.launches == launches + 1


@pytest.mark.cuda
def test_tree_on_the_card_stays_on_the_card(hopper):
    """NUTS on the tensor-op tree with CUDA tensors: a plain closure kept
    off the kernels (``trajectory_spec=None``; by default the card lowers
    it into a generated body) and per-chain adapt_full with the quadform
    kernel (128 chains, 100 + 100): the trace is finite, the engine the
    tree's, the quadform kernel ran at every leaf, and no trajectory
    kernel launched."""
    from littlemcmc_torch.ops import quadform

    def closure(q):
        return -0.5 * (q * q).sum(), -q

    report = {}
    trace, _ = sample(closure, model_ndim=3, chains=128, tune=100, draws=100, random_seed=2,
                      step=NUTS(model_ndim=3, trajectory_spec=None), perf_report=report,
                      progressbar=False)
    assert report["trajectory"] == "tensor" and np.isfinite(trace).all()
    assert abs(trace.reshape(-1, 3).var(0).mean() - 1) < 0.1
    model = tm.CorrelatedGaussian(10, use_kernel=True)
    launches = quadform.quadform_logp_grad.launches
    trace, stats = sample(model.logp_grad, model_ndim=10, chains=128, tune=100, draws=100,
                          random_seed=2, init="adapt_full", cross_chain_adapt=False,
                          perf_report=report, progressbar=False)
    assert report["engine"] == "per_draw_dense" and report["trajectory"] == "tensor"
    assert report["kernel_launches"] == {"nuts_trajectory": 0, "fused_nuts": 0}
    assert quadform.quadform_logp_grad.launches - launches >= 200
    assert np.isfinite(trace).all() and stats["diverging"].mean() < 0.01


# --------------------------------------------------------------------------
# the low-rank metric and the spiked Gaussian body
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("body,n,chains,metric", [
    ("spiked_gaussian", 100, 512, "lowrank"),
    ("correlated_gaussian", 100, 256, "lowrank"),
    ("spiked_gaussian", 12, 256, "lowrank"),
    ("spiked_gaussian", 100, 256, "diag"),
])
def test_lowrank_and_spiked_trajectory_kernel_matches_plain(hopper, body, n, chains, metric):
    """The trajectory kernel at kLowRank (the spiked Gaussian's body 4 and
    the correlated body 1) and body 4 at kDiag against the plain version:
    the smoke's phase 2m. The thin matvecs sum in the kernel's order in
    both, so trees agree but for the energy sums' order."""
    from chip_smoke import _compare, _lowrank_inputs, _posterior_inputs

    model = tm.SpikedGaussian(n) if body == "spiked_gaussian" else tm.CorrelatedGaussian(n)
    args, fac = (_lowrank_inputs(model, chains, 0.5, seed=n) if metric == "lowrank"
                 else (_posterior_inputs(model, chains, 0.1, seed=n), None))
    launches = trajectory.launches
    _compare(body, model, args, (13, -2), need=0.99, metric=metric, fac=fac)
    assert trajectory.launches == launches + 1


@pytest.mark.cuda
def test_spiked_body_in_the_hmc_kernel_matches_plain(hopper):
    res, failures, _, _ = hmc_check(tm.SpikedGaussian(100),
                                    _hmc_inputs(tm.SpikedGaussian(100), None, 256, 0.1, 5),
                                    (17, 19), 0.99)
    assert not failures, res


@pytest.mark.cuda
@pytest.mark.parametrize("step", ["nuts", "hmc"])
@pytest.mark.parametrize("tuning", [False, True], ids=["draw_chunk", "tune_chunk"])
def test_fused_lowrank_kernel_matches_plain(hopper, step, tuning):
    """The fused kernels' low-rank branch with body 4 against the plain
    version at 256 chains: a 2-draw draw chunk, and a 4-draw tune chunk
    with the per-chain Welford steps across a window swap and dual
    averaging on (the smoke's phase 2n)."""
    res, failures, _, _, _, _ = fused_check(tm.SpikedGaussian(100), 256, 4 if tuning else 2,
                                            tuning, True, seed=31, words=(37, -5), step=step,
                                            metric="lowrank")
    assert not failures, res


@pytest.mark.cuda
@pytest.mark.parametrize("step,fuse,engine,launches", [
    ("nuts", None, "fused_lowrank_pooled", {"nuts_trajectory": 0, "fused_nuts": 6}),
    ("nuts", False, "per_draw_lowrank_pooled", {"nuts_trajectory": 400, "fused_nuts": 0}),
    ("hmc", None, "fused_lowrank_pooled", {"hmc_trajectory": 0, "fused_hmc": 6}),
])
def test_lowrank_sample_on_the_card(hopper, step, fuse, engine, launches):
    """``init="jitter+adapt_lowrank"`` at 256 chains: pooled, fused by
    default (tune chunks of 10, 10, 30, 50 and 100 draws, then one draw
    chunk), per-draw with ``fuse_draws=False``; the posterior near the
    truth."""
    model = tm.SpikedGaussian(20)
    rep = {}
    kw = dict(model_ndim=20, chains=256, tune=200, draws=200, random_seed=5,
              init="jitter+adapt_lowrank", fuse_draws=fuse, perf_report=rep,
              progressbar=False)
    if step == "hmc":
        kw["step"] = HamiltonianMC(model_ndim=20)
    trace, stats = sample(model.logp_grad, **kw)
    assert rep["engine"] == engine and rep["kernel_launches"] == launches
    assert np.isfinite(trace).all() and stats["diverging"].mean() < 0.01
    ratio = trace.reshape(-1, 20).var(0) / model.true_var
    assert abs(ratio.mean() - 1) < 0.1, ratio


# --------------------------------------------------------------------------
# Neal's funnel (body 5) and the generated bodies
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_funnel_body_in_the_per_draw_kernels_matches_plain(hopper):
    """The per-draw NUTS and HMC kernels with the funnel body (5) against
    their plain versions, 512 chains, a quarter starting in the neck: the
    smoke's phase 2o; energies of divergent and far-off trajectories held
    ``scaled``."""
    from chip_smoke import _compare, _posterior_inputs

    f = tm.NealsFunnel(10)
    launches = trajectory.launches
    _compare("funnel", f, _posterior_inputs(f, 512, 0.2, seed=4), (5, -6), need=0.99)
    assert trajectory.launches == launches + 1
    res, failures, _, _ = hmc_check(f, _hmc_inputs(f, None, 512, 0.15, 5), (7, 8), 0.99,
                                    scaled=True)
    assert not failures, res


@pytest.mark.cuda
@pytest.mark.parametrize("step", ["nuts", "hmc"])
@pytest.mark.parametrize("tuning", [False, True], ids=["draw_chunk", "tune_chunk"])
def test_fused_funnel_kernel_matches_plain(hopper, step, tuning):
    """The fused kernels' kDiag instance with the funnel body against the
    plain version at 256 chains: a 2-draw draw chunk, a 4-draw tune chunk
    with the Welford steps and dual averaging on (the smoke's phase 2p)."""
    res, failures, _, _, _, _ = fused_check(tm.NealsFunnel(10), 256, 4 if tuning else 2,
                                            tuning, True, seed=9, words=(23, -5), step=step,
                                            metric="diag")
    assert not failures, res


@pytest.mark.cuda
def test_funnel_sample_on_the_card(hopper):
    """The centred funnel at 1024 chains, 250 + 250, target_accept 0.9, on
    ``fused_diag`` (two launches of the fused kernel): finite, v's sd at
    least 2 (the JAX study's arms 2.50-2.58 at 3000 draws)."""
    model = tm.NealsFunnel(10)
    report = {}
    trace, stats = sample(model.logp_grad, model_ndim=10, chains=1024, tune=250, draws=250,
                          random_seed=3, step=NUTS(model_ndim=10, target_accept=0.9),
                          perf_report=report, progressbar=False)
    assert report["engine"] == "fused_diag" and report["trajectory"] == "cuda"
    assert report["kernel_launches"] == {"nuts_trajectory": 0, "fused_nuts": 2}
    assert np.isfinite(trace).all() and trace[..., 0].std() > 2.0


def _auto_specs(dev):
    from littlemcmc_torch.models.probe_matrix import autospec_matrix
    from littlemcmc_torch.ops.autospec import make_trajectory_spec

    specs = [make_trajectory_spec(ndim=3, logp_fn=f, device=dev, name=name)
             for name, f in autospec_matrix(dev).items()]
    return specs + [tm.HierarchicalRegression().trajectory_spec()]


@pytest.mark.cuda
def test_probe_matrix_on_the_card(hopper):
    """The JAX probe matrix's nine models and ``HierarchicalRegression``
    through ``probe_specs``: one build of the probe kernel, every
    generated body within the probe's rtol 5e-3 / atol 1e-3 of its plain
    version (the smoke's phase 2q)."""
    from littlemcmc_torch.ops.autospec import probe_spec, probe_specs

    specs = _auto_specs(hopper)
    launches = probe_spec.launches
    report = probe_specs(specs)
    assert probe_spec.launches == launches + len(specs) and len(report) == 10
    assert all(s.auto.probed for s in specs)


@pytest.mark.cuda
def test_generated_body_in_the_kernels_matches_plain(hopper):
    """``HierarchicalRegression``'s generated body in the per-draw NUTS
    kernel (256 chains), the HMC kernel and the fused NUTS kernel (a
    2-draw draw chunk) against their plain versions (the smoke's phase
    2r); the body is probed before its first launch."""
    from chip_smoke import _compare, _posterior_inputs
    from littlemcmc_torch.ops.autospec import probe_spec

    model = tm.HierarchicalRegression()
    launches = probe_spec.launches
    _compare("hierarchical", model, _posterior_inputs(model, 256, 0.3, seed=6), (9, 10),
             need=0.99)
    assert probe_spec.launches == launches + 1 and model.trajectory_spec().auto.probed
    res, failures, _, _ = hmc_check(model, _hmc_inputs(model, None, 256, 0.3, 7), (11, 12),
                                    0.99, scaled=True)
    assert not failures, res
    res, failures, _, _, _, _ = fused_check(model, 256, 2, False, True, seed=8, words=(3, 4),
                                            step="nuts", metric="diag")
    assert not failures, res


@pytest.mark.cuda
@pytest.mark.parametrize("rows,in_smem", [(512, True), (1536, False)],
                         ids=["scratch_in_shared_memory", "scratch_in_global_memory"])
def test_generated_body_scratch_placement(hopper, rows, in_smem):
    """A generated body in all four kernels against their plain versions,
    with its scratch rows where each launch placed them: H1's
    ``HierarchicalRegression`` (512 rows: 1,584 scratch floats a warp, in
    shared memory beside its 39 KB of constants) and one of 1536 rows
    (4,656 floats a warp: 146 KB for 8 warps does not fit beside its 115
    KB of constants, so the global scratch stays). Every kernel says where
    its last launch put them (``autospec.scratch_in_smem``)."""
    from chip_smoke import _compare, _posterior_inputs
    from littlemcmc_torch.ops.autospec import MAX_SCRATCH_FLOATS, scratch_in_smem

    model = tm.HierarchicalRegression(n_rows=rows)
    spec = model.trajectory_spec()
    assert spec.auto.scratch_floats <= MAX_SCRATCH_FLOATS
    _compare("hierarchical", model, _posterior_inputs(model, 128, 0.3, seed=rows), (rows, 1),
             need=0.99)
    assert scratch_in_smem(spec, "nuts_trajectory") is in_smem
    res, failures, _, _ = hmc_check(model, _hmc_inputs(model, None, 128, 0.3, rows + 1),
                                    (rows, 2), 0.99, scaled=True)
    assert not failures, res
    assert scratch_in_smem(spec, "hmc_trajectory") is in_smem
    for step in ("nuts", "hmc"):
        res, failures, _, _, _, _ = fused_check(model, 64, 2, False, True, seed=rows + 2,
                                                words=(rows, 3), step=step, metric="diag")
        assert not failures, res
        assert scratch_in_smem(spec, f"fused_{step}") is in_smem
    # the probe keeps no constants in shared memory: both bodies' rows fit
    assert scratch_in_smem(spec, "autospec_probe")


@pytest.mark.cuda
def test_corrupted_generated_body_raises(hopper):
    """A generated body that computes another function (one ``log1pf``
    made ``logf`` by hand) fails its probe: ``probe_spec`` raises with the
    model's name, and so does the first kernel launch with it; nothing
    falls back."""
    from littlemcmc_torch.models.probe_matrix import autospec_matrix
    from littlemcmc_torch.ops.autospec import make_trajectory_spec, probe_spec

    def bad():
        spec = make_trajectory_spec(ndim=3, logp_fn=autospec_matrix(hopper)["student_t"],
                                    device=hopper, name="student_t_corrupted")
        assert "log1pf(" in spec.auto.body
        spec.auto.body = spec.auto.body.replace("log1pf(", "logf(", 1)
        return spec

    with pytest.raises(RuntimeError, match="student_t_corrupted"):
        probe_spec(bad())
    spec = bad()
    q = torch.zeros(8, 3, device=hopper)
    c = torch.zeros(8, device=hopper)
    with pytest.raises(RuntimeError, match="disagrees"):
        trajectory(q, q, q, c, c + 0.1, torch.full((8,), 3, dtype=torch.int32, device=hopper),
                   q + 1.0, 1, spec=spec, max_treedepth=3, Emax=1000.0)
    assert not spec.auto.probed


@pytest.mark.cuda
def test_user_model_auto_lowers_on_the_card(hopper, caplog):
    """``sample(logp_fn=f)`` for a torch model in the op set, on the card:
    the default spec is the generated one, so ``per_draw_diag`` runs on the
    trajectory kernel (``trajectory == "cuda"``, one launch a draw) and the
    log says so; a model that declines runs the tree."""
    import logging

    from littlemcmc_torch.models.probe_matrix import autospec_matrix

    f = autospec_matrix(hopper)["logistic"]
    report = {}
    with caplog.at_level(logging.INFO, logger="littlemcmc_torch"):
        trace, stats = sample(logp_fn=f, model_ndim=3, chains=256, tune=200, draws=200,
                              random_seed=2, perf_report=report, progressbar=False)
    assert any("Auto-lowered" in r.message for r in caplog.records)
    assert report["engine"] == "per_draw_diag" and report["trajectory"] == "cuda"
    assert report["kernel_launches"] == {"nuts_trajectory": 400, "fused_nuts": 0}
    assert np.isfinite(trace).all() and 0.6 < stats["mean_tree_accept"][:, -100:].mean() < 0.95
    report = {}
    sample(logp_fn=lambda q: -torch.sum(torch.cumsum(q, 0) ** 2), model_ndim=3, chains=64,
           tune=20, draws=20, random_seed=2, perf_report=report, progressbar=False,
           compute_convergence_checks=False)
    assert report["trajectory"] == "tensor"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cos", "grid_scratch", "smem_accumulate", "thin_factor",
                                  "stat_io_layout", "block_outputs_3d"])
def test_fused_probe_on_the_card(hopper, name):
    """Each fused-kernel capability probe (``csrc/fused_probe.cu``) on the
    card within the JAX probe's tolerance of its plain version, one
    launch counted."""
    from littlemcmc_torch.ops.fused_probe import check_probe, probe_kernel

    launches = probe_kernel.launches[name]
    assert check_probe(name, hopper) <= 1e-3
    assert probe_kernel.launches[name] == launches + 1


@pytest.mark.cuda
def test_corrupted_fused_probe_raises(hopper, monkeypatch):
    """A probe whose result disagrees raises, in ``check_probe`` and in the
    fused election of ``sample()``; nothing falls back to the per-draw
    engine."""
    from littlemcmc_torch.ops import fused_probe

    real = fused_probe.probe_plain

    def off(name, inputs, device="cpu"):
        out = real(name, inputs, device)
        return {k: v + 0.01 if name == "grid_scratch" else v for k, v in out.items()}

    monkeypatch.setattr(fused_probe, "probe_plain", off)
    with pytest.raises(RuntimeError, match="grid_scratch disagrees"):
        fused_probe.check_probe("grid_scratch", hopper)
    model = tm.NealsFunnel(10)
    with pytest.raises(RuntimeError, match="grid_scratch disagrees"):
        sample(model.logp_grad, model_ndim=10, chains=64, tune=10, draws=10, random_seed=1,
               progressbar=False)


@pytest.mark.cuda
@pytest.mark.parametrize("fuse_draws", [None, True], ids=["per_draw", "fused"])
def test_checkpoint_resume_on_the_card(hopper, fuse_draws, tmp_path):
    """An interrupt between chunks and a resume give an uninterrupted
    run's bits on the card: the per-draw kernel engine (the device
    generator's state in the checkpoint) and the fused one (its seed
    words)."""
    model = tm.CorrelatedGaussian(20)
    kw = dict(model_ndim=20, chains=256, tune=40, draws=60, random_seed=5,
              fuse_draws=fuse_draws, progressbar=False, compute_convergence_checks=False)

    def interrupt(iteration, tuning, states, chunk, n_divergences):
        if iteration >= 60:
            raise KeyboardInterrupt

    ckpt = str(tmp_path / "ckpt")
    part, _ = sample(model.logp_grad, checkpoint_dir=ckpt, checkpoint_every=20,
                     callback=interrupt, **kw)
    rest, _ = sample(model.logp_grad, checkpoint_dir=ckpt, resume=True, **kw)
    full, _ = sample(model.logp_grad, **kw)
    assert part.shape[1] == 20 and rest.shape[1] == 40
    np.testing.assert_array_equal(np.concatenate([part, rest], axis=1), full)


@pytest.mark.cuda
def test_device_trace_holds_one_record_a_launch(hopper, tmp_path):
    from littlemcmc_torch.utils.profiling import device_trace

    model = tm.CorrelatedGaussian(20)
    rep = {}
    with device_trace(str(tmp_path)) as tr:
        sample(model.logp_grad, model_ndim=20, chains=256, tune=20, draws=20, random_seed=1,
               perf_report=rep, progressbar=False, compute_convergence_checks=False)
    assert rep["kernel_launches"]["nuts_trajectory"] == 40
    assert tr.launches == {"nuts_trajectory": 40}
    assert tr.kernel_records("nuts_trajectory") == 40


@pytest.mark.cuda
def test_seed_list_and_step_rand_on_the_card(hopper):
    """A seed list runs the kernel engine reproducibly; an identity
    ``step_rand`` hook keeps the bits and elects the per-draw engine."""
    model = tm.CorrelatedGaussian(20)
    kw = dict(model_ndim=20, chains=64, tune=20, draws=20, progressbar=False,
              compute_convergence_checks=False)
    a, _ = sample(model.logp_grad, random_seed=list(range(64)), **kw)
    b, _ = sample(model.logp_grad, random_seed=list(range(64)), **kw)
    np.testing.assert_array_equal(a, b)
    c, _ = sample(model.logp_grad, random_seed=3, **kw)
    rep = {}
    d, _ = sample(model.logp_grad, random_seed=3, perf_report=rep,
                  step=NUTS(model_ndim=20, step_rand=lambda s, g: s), **kw)
    np.testing.assert_array_equal(c, d)
    assert rep["engine"] == "per_draw_diag" and rep["trajectory"] == "cuda"


@pytest.mark.cuda
def test_stochastic_volatility_on_the_card(hopper):
    """``StochasticVolatility(T=64)`` on its generated body with the JAX
    package's gates (``tests/test_models.py:187-207``)."""
    from littlemcmc_torch.utils.diagnostics import split_rhat

    m = tm.StochasticVolatility(T=64)
    rep = {}
    trace, stats = sample(m.logp_grad, model_ndim=m.ndim, tune=600, draws=600, chains=8,
                          random_seed=4, target_accept=0.95, progressbar=False,
                          perf_report=rep)
    assert rep["trajectory"] == "cuda"
    flat = trace.reshape(-1, m.ndim)
    phi = np.tanh(flat[:, 0])
    assert abs(phi.mean() - m.true_phi) < 3 * phi.std() + 0.02
    assert max(float(split_rhat(trace[:, :, i])) for i in range(3)) < 1.06
    assert float(np.mean(stats["diverging"])) < 0.02
    assert np.corrcoef(flat[:, 3:].mean(axis=0), m.h_true)[0, 1] > 0.85


@pytest.mark.cuda
def test_linear_regression_on_the_card(hopper):
    m = tm.LinearRegression()
    rep = {}
    trace, _ = sample(m.logp_grad, model_ndim=3, chains=256, tune=300, draws=300,
                      random_seed=4, progressbar=False, perf_report=rep)
    assert rep["trajectory"] == "cuda"
    exact = m.posterior_moments()
    flat = trace.reshape(-1, 3)
    assert np.all(np.abs(flat.mean(0) - exact["mean"]) < 0.1 * exact["sd"])
    np.testing.assert_allclose(flat.std(0), exact["sd"], rtol=0.1)
