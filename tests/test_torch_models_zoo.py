"""The linear-regression and stochastic-volatility models of the port
(``littlemcmc_torch.models.{linear,stochvol}``) against the JAX package's
(``littlemcmc_tpu/models/{linear,stochvol}.py``) on the CPU.

- Their data equal the JAX models' to the bit (both draw from
  ``np.random.RandomState(seed)`` in one order).
- ``logp`` and its gradient, one chain and batched (stochastic
  volatility's batched gradient is written by hand), at 8 seeded
  positions: rtol 1e-5, atol 1e-5.
- The body generated from each ``logp`` (``trajectory_spec()``, the one the
  card runs in the per-draw NUTS kernel) lowers, and its numpy interpreter
  gives the traced graph's logp and gradient (rtol 1e-5, atol 1e-4);
  ``StochasticVolatility(T=500)`` (503 parameters) declines and samples on
  the tensor-op tree.
- Linear regression sampled by both packages (the port on the generated
  body's plain trajectory): posterior means within 4.5 Monte Carlo sds of
  the flat-prior closed form and of each other, sds within 10%.
The stochastic-volatility run with the JAX package's gates is
``tests/test_torch_stochvol.py``.
"""

import numpy as np
import pytest
import torch

import littlemcmc_tpu as lmc
import littlemcmc_torch as lt
from littlemcmc_tpu import models as jm
from littlemcmc_torch import models as tm
from littlemcmc_torch.ops import autospec
from littlemcmc_torch.utils.diagnostics import ess_bulk

torch.set_num_threads(1)

CASES = {"linear": (tm.LinearRegression, jm.LinearRegression, {}),
         "stochvol_T64": (tm.StochasticVolatility, jm.StochasticVolatility, {"T": 64}),
         "stochvol_T128": (tm.StochasticVolatility, jm.StochasticVolatility, {})}


def _models(name):
    port, jax_cls, kw = CASES[name]
    return port(device="cpu", **kw), jax_cls(**kw)


def _positions(ndim, k=8, seed=0):
    """``k`` seeded positions inside the models' support (phi_raw ~ 1.5,
    mu ~ -1 for stochastic volatility)."""
    q = (np.random.RandomState(seed).randn(k, ndim) * 0.5).astype(np.float32)
    if ndim > 3:
        q[:, 0] += 1.5
        q[:, 2] -= 1.0
    return q


def test_linear_regression_data_match_jax_bits():
    t, j = _models("linear")
    np.testing.assert_array_equal(t.x.numpy(), np.asarray(j._x))
    np.testing.assert_array_equal(t.y.numpy(), np.asarray(j._y))
    np.testing.assert_array_equal(t.true_params, j.true_params)
    assert t.ndim == j.ndim == 3


@pytest.mark.parametrize("name", ["stochvol_T64", "stochvol_T128"])
def test_stochastic_volatility_data_match_jax_bits(name):
    t, j = _models(name)
    np.testing.assert_array_equal(t.y2.numpy(), np.asarray(j._y2))
    np.testing.assert_array_equal(t.h_true, j.h_true)
    np.testing.assert_array_equal(t.y, j.y)
    assert t.ndim == j.ndim == t.T + 3


@pytest.mark.parametrize("name", sorted(CASES))
def test_logp_and_grad_match_jax(name):
    import jax
    import jax.numpy as jnp

    t, j = _models(name)
    q = _positions(t.ndim)
    jl, jg = jax.vmap(j.logp_grad)(jnp.asarray(q))
    jl, jg = np.asarray(jl), np.asarray(jg)
    for i in range(len(q)):
        lp, g = t.logp_grad(torch.from_numpy(q[i]))
        np.testing.assert_allclose(float(lp), jl[i], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g.numpy(), jg[i], rtol=1e-5, atol=1e-5)
    blp, bg = t.batched_logp_grad(torch.from_numpy(q))
    np.testing.assert_allclose(blp.numpy(), jl, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bg.numpy(), jg, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_generated_body_lowers_and_interprets(name):
    t, _ = _models(name)
    spec = t.trajectory_spec()
    assert spec is not None and spec.body == "auto" and spec.ndim == t.ndim
    assert t.trajectory_spec() is spec  # traced once
    for q in _positions(t.ndim, k=3, seed=1):
        lp, g = t.logp_grad(torch.from_numpy(q))
        ilp, ig = autospec.interpret(spec.auto, q)
        np.testing.assert_allclose(float(ilp), float(lp), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(np.asarray(ig), g.numpy(), rtol=1e-5, atol=1e-4)


def test_stochastic_volatility_T500_declines_to_the_tree():
    m = tm.StochasticVolatility(T=500, device="cpu")
    assert m.ndim == 503
    assert m.trajectory_spec() is None and "503 parameters" in m.decline_reason
    rep = {}
    trace, _ = lt.sample(m.logp_grad, model_ndim=m.ndim, chains=2, tune=3, draws=3,
                         random_seed=1, device="cpu", progressbar=False,
                         compute_convergence_checks=False, perf_report=rep)
    assert trace.shape == (2, 3, 503) and np.isfinite(trace).all()
    assert rep["trajectory"] == "tensor" and rep["engine"] == "per_draw_diag"


def _summary(trace):
    flat = trace.reshape(-1, trace.shape[2])
    ess = np.array([ess_bulk(trace[:, :, i]) for i in range(trace.shape[2])])
    return flat.mean(0), flat.std(0), flat.std(0) / np.sqrt(ess)


def test_linear_regression_sample_matches_jax_and_closed_form():
    t, j = _models("linear")
    kw = dict(model_ndim=3, chains=16, tune=300, draws=300, random_seed=4, progressbar=False)
    rep = {}
    t_trace, _ = lt.sample(t.logp_grad, device="cpu", perf_report=rep, **kw)
    assert rep["trajectory"] == "plain" and rep["engine"] == "per_draw_diag"
    j_trace, _ = lmc.sample(j.logp_grad, **kw)
    exact = t.posterior_moments()
    tm_, ts, tmc = _summary(t_trace)
    jm_, js, jmc = _summary(np.asarray(j_trace))
    assert np.all(np.abs(tm_ - exact["mean"]) < 4.5 * tmc), (tm_, exact["mean"], tmc)
    assert np.all(np.abs(tm_ - jm_) < 4.5 * np.hypot(tmc, jmc))
    np.testing.assert_allclose(ts, exact["sd"], rtol=0.1)
    np.testing.assert_allclose(ts, js, rtol=0.1)


def test_models_are_exported():
    assert lt.models.LinearRegression is tm.LinearRegression
    assert lt.models.StochasticVolatility is tm.StochasticVolatility
