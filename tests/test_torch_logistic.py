"""The port's logistic regression and its two batched model kernels, held
against the JAX package on the CPU.

- (a) ``german_credit_synthetic`` and the model's design, to the bit;
  ``logp_grad`` and ``batched_logp_grad`` against the JAX model's;
- (b) ``logistic_logp_grad_plain`` against ``make_logistic_logp_grad`` and
  ``quadform_logp_grad_plain`` against ``quadform_logp_grad`` (the Pallas
  kernels in interpret mode on the CPU), with ``tests/test_ops.py``'s
  tolerances, and the ``use_kernel`` flags on CPU tensors;
- (c) the NUTS trajectory op's plain version with the logistic body against
  ``build_trajectory_op(interpret=True, pack=1)`` with the JAX model's
  spec: at least 99% of chains agree;
- (d) the logistic body's spec checks and the engine election of paths
  (A) (the tree with the batched model) and (B) (the default call);
- (e) the tree on the full model (1000 x 25) against the reference
  moments of a long JAX run.

Run as a script, this file writes those reference moments (see
:func:`reference_moments`), which ``chip_smoke.py`` also holds the card's
logistic runs to::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_logistic.py
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import littlemcmc_tpu as lmc
import littlemcmc_torch as lt
from littlemcmc_tpu import models as jm
from littlemcmc_tpu.ops import build_trajectory_op, quadform_logp_grad
from littlemcmc_tpu.ops.logistic_pallas import make_logistic_logp_grad
from littlemcmc_tpu.utils.diagnostics import ess_bulk, split_rhat
from littlemcmc_torch import models as tm
from littlemcmc_torch.ops.logistic import logistic_logp_grad, logistic_logp_grad_plain
from littlemcmc_torch.ops.nuts_trajectory import TrajectorySpec, trajectory
from littlemcmc_torch.ops.quadform import quadform_logp_grad as t_quadform
from littlemcmc_torch.ops.quadform import quadform_logp_grad_plain

torch.set_num_threads(1)

REFERENCE = Path(__file__).resolve().parent / "logistic_reference_moments.json"
REF_RUN = dict(chains=128, tune=1000, draws=2000, random_seed=2024)


def reference_moments(chains, tune, draws, random_seed):
    """The 25 posterior means and sds of BASELINE config 4
    (``LogisticRegression()``: ``german_credit_synthetic``'s 1000 x 24
    design, intercept folded in, N(0, 10^2) prior) from one long run of the
    JAX package's NUTS on the CPU (its tensor-op tree, jitter+adapt_diag),
    with each mean's Monte Carlo standard error from the bulk ESS."""
    model = jm.LogisticRegression()
    trace, stats = lmc.sample(logp_dlogp_func=model.logp_grad, model_ndim=model.ndim,
                              chains=chains, tune=tune, draws=draws, random_seed=random_seed,
                              progressbar=False)
    trace = np.asarray(trace, np.float64)
    flat = trace.reshape(-1, model.ndim)
    sd = flat.std(0)
    ess = np.array([ess_bulk(trace[:, :, i]) for i in range(model.ndim)])
    return {
        "source": "littlemcmc_tpu.sample(LogisticRegression().logp_grad) on the CPU",
        "command": "JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_logistic.py",
        **{k: int(v) for k, v in dict(chains=chains, tune=tune, draws=draws,
                                      random_seed=random_seed).items()},
        "mean": flat.mean(0).tolist(),
        "sd": sd.tolist(),
        "mcse_mean": (sd / np.sqrt(ess)).tolist(),
        "min_bulk_ess": float(ess.min()),
        "max_split_rhat": float(max(split_rhat(trace[:, :, i]) for i in range(model.ndim))),
        "divergence_rate": float(np.asarray(stats["diverging"]).mean()),
        "mean_depth": float(np.asarray(stats["depth"]).mean()),
    }


SEED = (97531, -4242)
FLAGS = ("depth", "n_leaves", "diverging", "turning")
CB = 8


def _small_models(prior_scale=5.0):
    """Both packages' model on a 300 x 9 synthetic design (10 parameters)."""
    X, y = jm.german_credit_synthetic(300, 9)
    return (jm.LogisticRegression(X, y, prior_scale=prior_scale),
            tm.LogisticRegression(X, y, prior_scale=prior_scale, device="cpu"))


# --------------------------------------------------------------------------
# (a) the data and the model
# --------------------------------------------------------------------------

def test_data_and_design_match_jax_to_the_bit():
    """(a) the synthetic German-credit data of both packages, and the
    float32 design and responses of their default models, are equal."""
    for args in ((), (300, 9), (120, 6, 3)):
        jx, jy = jm.german_credit_synthetic(*args)
        tx, ty = tm.german_credit_synthetic(*args)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    jmodel, tmodel = jm.LogisticRegression(), tm.LogisticRegression(device="cpu")
    assert tmodel.ndim == jmodel.ndim == 25
    np.testing.assert_array_equal(tmodel.Xb.numpy(), np.asarray(jmodel._Xb))
    np.testing.assert_array_equal(tmodel.y.numpy(), np.asarray(jmodel._y))


def test_logp_grad_matches_jax_model():
    """(a) the default model (1000 x 25) at 16 points, batched and one
    chain at a time: logp within 1e-5 relative (about -700 summed over
    1000 rows in two orders), grad within 1e-4 of its size (sums of
    1000 rows)."""
    q = (np.random.default_rng(0).standard_normal((16, 25)) * 0.3).astype(np.float32)
    jmodel, tmodel = jm.LogisticRegression(), tm.LogisticRegression(device="cpu")
    lp, g = (np.asarray(x) for x in jax.vmap(jmodel.logp_grad)(jnp.asarray(q)))
    tlp, tg = (x.numpy() for x in tmodel.batched_logp_grad(torch.from_numpy(q)))
    np.testing.assert_allclose(tlp, lp, rtol=1e-5)
    np.testing.assert_allclose(tg, g, rtol=0, atol=1e-4 * np.abs(g).max())
    for i in (0, 7):
        lp1, g1 = tmodel.logp_grad(torch.from_numpy(q[i]))
        np.testing.assert_allclose(float(lp1), lp[i], rtol=1e-5)
        np.testing.assert_allclose(g1.numpy(), g[i], rtol=0, atol=1e-4 * np.abs(g).max())


# --------------------------------------------------------------------------
# (b) the batched model kernels' plain versions
# --------------------------------------------------------------------------

def test_logistic_plain_matches_pallas_kernel():
    """(b) ``make_logistic_logp_grad`` in interpret mode (padded to its
    tiles, the pad rows' log 2 subtracted) against the plain version,
    unpadded, with ``tests/test_ops.py:55-56``'s tolerances; on CPU tensors
    the wrapper and the ``use_kernel`` model run the plain version and
    count no launch."""
    X, y = jm.german_credit_synthetic(300, 9)
    xb = np.concatenate([np.ones((300, 1)), X], axis=1)
    q = (np.random.RandomState(3).randn(6, 10) * 0.3).astype(np.float32)
    lp, g = (np.asarray(x) for x in make_logistic_logp_grad(xb, y, 5.0)(jnp.asarray(q)))
    args = (torch.from_numpy(xb.astype(np.float32)), torch.from_numpy(y.astype(np.float32)),
            torch.tensor([1.0 / 25.0]))
    tlp, tg = logistic_logp_grad_plain(torch.from_numpy(q), *args)
    np.testing.assert_allclose(tlp.numpy(), lp, rtol=3e-4, atol=1e-2)
    np.testing.assert_allclose(tg.numpy(), g, rtol=3e-4, atol=1e-3)
    launches = logistic_logp_grad.launches
    klp, kg = logistic_logp_grad(torch.from_numpy(q), *args)
    mlp, mg = tm.LogisticRegression(X, y, prior_scale=5.0, use_kernel=True,
                                    device="cpu").batched_logp_grad(torch.from_numpy(q))
    assert logistic_logp_grad.launches == launches
    for a, b in ((klp, tlp), (kg, tg), (mlp, tlp), (mg, tg)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("chains,n", [(32, 10), (5, 7)])
def test_quadform_plain_matches_pallas_kernel(chains, n):
    """(b) ``quadform_logp_grad`` in interpret mode against the plain
    version, at a tile-aligned and an odd shape, with
    ``tests/test_ops.py:31-32``'s tolerances; the ``use_kernel``
    correlated Gaussian runs the plain version on CPU tensors."""
    jmodel = jm.CorrelatedGaussian(n, rho=0.6, scale_range=(0.5, 2.0))
    prec = jmodel.prec.astype(np.float32)
    q = np.random.RandomState(chains).randn(chains, n).astype(np.float32)
    lp, g = (np.asarray(x) for x in quadform_logp_grad(jnp.asarray(q), jnp.asarray(prec)))
    tlp, tg = quadform_logp_grad_plain(torch.from_numpy(q), torch.from_numpy(prec))
    np.testing.assert_allclose(tlp.numpy(), lp, rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(tg.numpy(), g, rtol=2e-4, atol=1e-4)
    launches = t_quadform.launches
    tmodel = tm.CorrelatedGaussian(n, rho=0.6, scale_range=(0.5, 2.0), use_kernel=True,
                                   device="cpu")
    mlp, mg = tmodel.batched_logp_grad(torch.from_numpy(q))
    assert t_quadform.launches == launches
    np.testing.assert_array_equal(mlp.numpy(), tlp.numpy())
    np.testing.assert_array_equal(mg.numpy(), tg.numpy())


# --------------------------------------------------------------------------
# (c) the trajectory op's logistic body
# --------------------------------------------------------------------------

def test_trajectory_plain_matches_jax_logistic():
    """(c) one NUTS transition of 64 chains in blocks of 8 on the 300 x 10
    model: at least 99% of chains agree on every flag; on those, q within
    1e-5 of its posterior scale (0.1) and the energies within 1e-4
    relative (sums over 300 rows in two orders, through up to 2^8 steps)."""
    jmodel, tmodel = _small_models()
    n, Cn, D = 10, 64, 8
    rng = np.random.default_rng(1)
    q = (rng.standard_normal((Cn, n)) * 0.1).astype(np.float32)
    var = (0.01 * rng.uniform(0.5, 2.0, (Cn, n))).astype(np.float32)
    p = (rng.standard_normal((Cn, n)) / np.sqrt(var)).astype(np.float32)
    eps = (0.25 * rng.uniform(0.7, 1.3, Cn)).astype(np.float32)
    mdc = np.full(Cn, D, np.int32)
    mdc[::5] = D - 2
    lp, g = (np.asarray(x) for x in jax.vmap(jmodel.logp_grad)(jnp.asarray(q)))
    op = build_trajectory_op(jmodel.pallas_trajectory_spec(), n, D, 1000.0, interpret=True,
                             chain_block=CB, pack=1)
    want = jax.tree.map(np.asarray, op(q, p, g, lp, eps, mdc, var,
                                       jnp.asarray(SEED, jnp.int32)))
    t = [torch.from_numpy(np.array(x)) for x in (q, p, g, lp, eps, mdc, var)]
    launches = trajectory.launches
    got = trajectory(*t, SEED, spec=tmodel.trajectory_spec(), max_treedepth=D, Emax=1000.0,
                     chain_block=CB)
    assert trajectory.launches == launches  # the CPU runs the plain version
    got = {k: v.numpy() for k, v in got.items()}
    agree = np.all([got[k] == want[k] for k in FLAGS], axis=0)
    assert agree.mean() >= 0.99, agree
    assert want["depth"].mean() > 2
    np.testing.assert_allclose(got["q"][agree] / 0.1, want["q"][agree] / 0.1, atol=1e-5,
                               rtol=0)
    for k in ("energy", "logp", "log_size"):
        np.testing.assert_allclose(got[k][agree], want[k][agree], atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------
# (d) the spec and the election
# --------------------------------------------------------------------------

def test_logistic_spec_and_election():
    """(d) the body's constants are checked and packed for the kernels;
    the default call elects ``per_draw_diag`` on the trajectory op (the
    JAX rule: no lane-packed body, so pack 1); the tree with the batched
    model (path A) is ``per_draw_diag`` on tensor ops; ``fuse_draws=True``
    runs the fused op's body 3."""
    _, tmodel = _small_models()
    spec = tmodel.trajectory_spec()
    assert spec.body == "logistic" and spec.rows == 300 and not spec.packable
    # Xb at the odd row stride 11 (a zero column), then y, then the prior
    # precision
    packed = spec.kernel_consts
    assert packed.shape == (300 * 11 + 300 + 1,)
    np.testing.assert_array_equal(packed[:3300].reshape(300, 11)[:, :10].numpy(),
                                  tmodel.Xb.numpy())
    assert not packed[:3300].reshape(300, 11)[:, 10].any()
    assert float(packed[-1]) == np.float32(1.0 / 25.0)
    with pytest.raises(ValueError, match="constants of shapes"):
        TrajectorySpec("logistic", (tmodel.Xb, tmodel.y[:-1], tmodel.prior_prec), 10)
    kw = dict(model_ndim=10, chains=16, tune=4, draws=2, random_seed=1, device="cpu",
              progressbar=False, compute_convergence_checks=False)
    for step, fuse, want in ((None, None, ("per_draw_diag", "plain")),
                             (lt.NUTS(model_ndim=10, batched_logp_dlogp_func=tm.LogisticRegression(
                                 *jm.german_credit_synthetic(300, 9), prior_scale=5.0,
                                 use_kernel=True, device="cpu").batched_logp_grad,
                                 trajectory_spec=None), None, ("per_draw_diag", "tensor")),
                             (None, True, ("fused_diag", "plain"))):
        report = {}
        trace, stats = lt.sample(tmodel.logp_grad, step=step, fuse_draws=fuse,
                                 perf_report=report, **kw)
        assert (report["engine"], report["trajectory"]) == want
        assert trace.shape == (16, 2, 10) and np.isfinite(trace).all()


# --------------------------------------------------------------------------
# (e) the tree on the full model
# --------------------------------------------------------------------------

def test_tree_on_full_model_matches_reference_moments():
    """(e) path (A) at a CPU size: the tree on the default model (1000 x
    25) through the batched model with ``use_kernel=True`` (its plain
    version on CPU tensors), 16 chains, 200 tune + 250 draws: every
    posterior mean within 5 Monte Carlo errors of the reference's (the
    reference's own error is 0.3% of an sd), every sd within 15%."""
    ref = json.loads(REFERENCE.read_text())
    model = tm.LogisticRegression(use_kernel=True, device="cpu")
    report = {}
    trace, stats = lt.sample(model.logp_grad, model_ndim=25, chains=16, tune=200, draws=250,
                             random_seed=42, device="cpu", perf_report=report,
                             progressbar=False,
                             step=lt.NUTS(model_ndim=25, batched_logp_dlogp_func=model.
                                          batched_logp_grad, trajectory_spec=None))
    assert report["trajectory"] == "tensor" and stats["diverging"].sum() == 0
    mean, sd = np.array(ref["mean"]), np.array(ref["sd"])
    for i in range(25):
        se = sd[i] / np.sqrt(ess_bulk(trace[:, :, i]))
        assert abs(trace[:, :, i].mean() - mean[i]) < 5 * se, (i, trace[:, :, i].mean(), se)
    ratio = trace.reshape(-1, 25).std(0) / sd
    assert np.all(np.abs(ratio - 1) < 0.15), ratio


if __name__ == "__main__":
    REFERENCE.write_text(json.dumps(reference_moments(**REF_RUN), indent=1) + "\n")
    print(REFERENCE.read_text())
    sys.exit(0)
