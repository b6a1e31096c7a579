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

from chip_smoke import FLAGS, _held, _hmc_inputs, fused_check, hmc_check


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
    ("quadform", 5, 7, 0),
    ("quadform", 1024, 100, 0),
    ("quadform", 19, 33, 0),
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
