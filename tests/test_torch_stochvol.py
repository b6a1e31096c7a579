"""Stochastic volatility (``littlemcmc_torch.models.StochasticVolatility``,
T = 64) sampled on the CPU with the JAX package's gates
(``tests/test_models.py:187-207``: 8 chains, 600 + 600, ``target_accept=
0.95``, seed 4: phi within 3 posterior sds + 0.02 of the truth, the
globals' split R-hat < 1.06, divergences < 2%, the latent path's posterior
mean correlated > 0.85 with the true path), and its globals' posterior
means within 4.5 Monte Carlo sds of the JAX package's same run.

The port runs the tensor-op tree with the model's hand-written batched
gradient (``trajectory_spec=None``): the generated body's plain trajectory
replays the traced graph at every leaf, about 3x slower on the CPU. The
run takes about two minutes (the tree's host work at some 70 leaves a
draw); the card runs the generated body (``chip_smoke.py``).
"""

import numpy as np
import torch

import littlemcmc_tpu as lmc
import littlemcmc_torch as lt
from littlemcmc_tpu import models as jm
from littlemcmc_torch.models import StochasticVolatility
from littlemcmc_torch.utils.diagnostics import ess_bulk, split_rhat

torch.set_num_threads(1)


def test_stochastic_volatility_samples_and_recovers_like_jax():
    m = StochasticVolatility(T=64, device="cpu")
    kw = dict(model_ndim=m.ndim, tune=600, draws=600, chains=8, random_seed=4,
              progressbar=False)
    rep = {}
    trace, stats = lt.sample(
        m.logp_grad, device="cpu", perf_report=rep,
        step=lt.NUTS(model_ndim=m.ndim, target_accept=0.95, trajectory_spec=None), **kw)
    assert rep["trajectory"] == "tensor"
    flat = trace.reshape(-1, m.ndim)
    phi = np.tanh(flat[:, 0])
    assert abs(phi.mean() - m.true_phi) < 3 * phi.std() + 0.02
    rh = max(float(split_rhat(trace[:, :, i])) for i in range(3))
    assert rh < 1.06, rh
    assert float(np.mean(stats["diverging"])) < 0.02
    hbar = flat[:, 3:].mean(axis=0)
    assert np.corrcoef(hbar, m.h_true)[0, 1] > 0.85

    jmodel = jm.StochasticVolatility(T=64)
    j_trace, _ = lmc.sample(jmodel.logp_grad, target_accept=0.95, **kw)
    j_trace = np.asarray(j_trace)
    for i in range(3):
        mc = [trace[:, :, i].std() / np.sqrt(ess_bulk(trace[:, :, i])),
              j_trace[:, :, i].std() / np.sqrt(ess_bulk(j_trace[:, :, i]))]
        diff = trace[:, :, i].mean() - j_trace[:, :, i].mean()
        assert abs(diff) < 4.5 * np.hypot(*mc), (i, diff, mc)
