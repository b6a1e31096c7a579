"""The port's CUDA kernel on the card, held against its plain version.

Imports no JAX, so it runs on a machine with a CUDA card and PyTorch alone:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` skips the repository's conftest files, which set up
JAX.) Every test here needs a CUDA device of compute capability 9.0 and
skips elsewhere. The kernel and the plain version draw the same counter
stream, so they build the same trees; the correlated Gaussian's matvec
sums in another order in each, and a rounding difference can flip one
decision and, through the block's shared counter, the rest of its block.
"""

import numpy as np
import pytest
import torch

from littlemcmc_torch import models as tm
from littlemcmc_torch import sample
from littlemcmc_torch.ops import trajectory, trajectory_plain

FLAGS = ("depth", "n_leaves", "diverging", "turning")


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
    assert report["kernel_launches"] == 300 and report["trajectory"] == "cuda"
    assert trace.shape == (256, 150, 20) and np.isfinite(trace).all()
    assert stats["diverging"].mean() < 0.01
    assert abs((trace.reshape(-1, 20).var(0) / model.true_var).mean() - 1) < 0.1
