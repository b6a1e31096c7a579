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
    """NUTS on the tensor-op tree with CUDA tensors: a plain closure and
    per-chain adapt_full with the quadform kernel (128 chains, 100 + 100):
    the trace is finite, the engine the tree's, the quadform kernel ran at
    every leaf, and no trajectory kernel launched."""
    from littlemcmc_torch.ops import quadform

    def closure(q):
        return -0.5 * (q * q).sum(), -q

    report = {}
    trace, _ = sample(closure, model_ndim=3, chains=128, tune=100, draws=100, random_seed=2,
                      perf_report=report, progressbar=False)
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
