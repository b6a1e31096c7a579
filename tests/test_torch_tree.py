"""The port's tensor-op NUTS tree, held against the JAX package on the CPU.

- (a) ``_leapfrog_b`` and ``_merge_nodes`` against JAX's on the same
  inputs (the same uniforms, so the same ``take2``);
- (b) ``run_nuts_tree`` against JAX's, chain for chain: the port's tree
  draws through a random source that wraps ``jax.random`` with the same
  threefry keys (:class:`JaxTreeRandom`), both trees start from the same
  state (carried across by ``convert.phase_state_from_numpy``), for a
  diagonal metric, a static dense one and a per-chain adaptive dense one;
- (c) ``sample()`` on the tree against JAX's ``sample`` with
  ``pallas_trajectory=None`` (its tensor-op tree), for a plain closure and
  for per-chain ``adapt_full``, within Monte Carlo error;
- (d) ``model.from_numpy_callable`` against JAX's, and ``sample()`` through
  it;
- (e) the metrics no kernel takes run on the tree: ``QuadPotentialFullInv``
  and per-chain dense adaptation with ``fuse_draws=True`` refused.

The JAX package's chains each draw from their own key, so one chain's
rounding never moves another's draws: chains are held one by one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import littlemcmc_tpu as lmc
import littlemcmc_torch as lt
from littlemcmc_tpu import models as jm
from littlemcmc_tpu import nuts as jnuts
from littlemcmc_tpu import quadpotential as jqp
from littlemcmc_tpu.base import NUTSConfig as JNUTSConfig
from littlemcmc_tpu.model import from_numpy_callable as j_from_numpy_callable
from littlemcmc_torch import models as tm
from littlemcmc_torch import nuts as tnuts
from littlemcmc_torch import quadpotential as tqp
from littlemcmc_torch.base import NUTSConfig
from littlemcmc_torch.convert import phase_state_from_numpy, tree_node_from_numpy
from littlemcmc_torch.model import from_numpy_callable
from littlemcmc_torch.utils.diagnostics import ess_bulk

torch.set_num_threads(1)

N, C, D = 5, 32, 8
TREE_FLAGS = ("depth", "n_proposals", "diverging", "turning", "reached_max_treedepth")


class JaxTreeRandom:
    """The tree's random source on ``jax.random``: (C, 2) threefry keys,
    split and drawn per chain as the JAX package's tree does
    (``_split_each``, ``jax.random.bernoulli``, ``_logbern_b``)."""

    def split(self, keys, num):
        out = jax.vmap(lambda k: jax.random.split(k, num))(keys)
        return tuple(out[:, i] for i in range(num))

    def where(self, mask, a, b):
        return jnp.where(jnp.asarray(mask.numpy())[:, None], a, b)

    def bernoulli(self, keys):
        return torch.from_numpy(np.array(jax.vmap(jax.random.bernoulli)(keys)))

    def uniform(self, keys):
        return torch.from_numpy(np.array(jax.vmap(jax.random.uniform)(keys)))


def _np(tree):
    return {k: None if v is None else np.asarray(v) for k, v in tree._asdict().items()}


def _metric(kind, rng, model):
    """The same metric in both packages, batched over C chains: a diagonal
    near the true variances, the true covariance shared, or a per-chain
    dense covariance (an adaptive metric's state as the tree reads it)."""
    if kind == "diag":
        v = (model.true_var * rng.uniform(0.5, 2.0, (C, N))).astype(np.float32)
        return (jqp.QuadPotentialDiag.create(jnp.asarray(v)),
                tqp.QuadPotentialDiag.create(torch.from_numpy(v)))
    if kind == "dense":
        cov = np.broadcast_to(model.cov.astype(np.float32), (C, N, N)).copy()
        chol = np.linalg.cholesky(cov.astype(np.float64)).astype(np.float32)
        return (jqp.QuadPotentialFull(cov=jnp.asarray(cov), chol=jnp.asarray(chol)),
                tqp.QuadPotentialFull(cov=torch.from_numpy(cov), chol=torch.from_numpy(chol)))
    a = rng.standard_normal((C, N, N)) * 0.3
    cov = (model.cov * np.exp(rng.uniform(-0.5, 0.5, (C, 1, 1)))
           + a @ np.swapaxes(a, 1, 2) * np.sqrt(np.outer(model.true_var, model.true_var)))
    cov = cov.astype(np.float32)
    chol = np.linalg.cholesky(cov.astype(np.float64)).astype(np.float32)
    jpot = jax.vmap(lambda c: jqp.QuadPotentialFullAdapt.create(N, initial_cov=c))(
        jnp.asarray(cov))
    jpot = jpot.replace(cov=jnp.asarray(cov), chol=jnp.asarray(chol))
    tpot = tqp.QuadPotentialFullAdapt.create(torch.zeros(C, N))
    tpot = tpot.replace(cov=torch.from_numpy(cov), chol=torch.from_numpy(chol))
    return jpot, tpot


def _start(rng, jmodel, jpot):
    """A start state at stationarity, made by the JAX package: q ~ N(0,
    cov), p from the metric, logp and grad from the model."""
    chol = np.linalg.cholesky(jmodel.cov)
    q = jnp.asarray((rng.standard_normal((C, N)) @ chol.T).astype(np.float32))
    p = jax.vmap(lambda pot, k: pot.sample_momentum(k))(
        jpot, jax.random.split(jax.random.PRNGKey(int(rng.integers(1 << 30))), C))
    logp, grad = jax.vmap(jmodel.logp_grad)(q)
    velocity_b, kinetic_b = jnuts._make_batched_potential_ops(jpot)
    energy = kinetic_b(p, velocity_b(p)) - logp
    return jnuts.PhaseState(q, p, grad, energy, logp)


# --------------------------------------------------------------------------
# (a) the leapfrog and the merge
# --------------------------------------------------------------------------

def test_leapfrog_b_matches_jax():
    """(a) one batched leapfrog. With a diagonal metric and an elementwise
    gradient (the standard normal) q, p, grad and the velocity equal the
    JAX package's bit for bit; logp and the energy are sums, which the
    two packages order their own way: within 2e-6. With the correlated
    Gaussian and a dense metric (matvecs summed in each package's order)
    every field within 2e-6."""
    rng = np.random.default_rng(0)
    jmodel, tmodel = jm.CorrelatedGaussian(N), tm.CorrelatedGaussian(N, device="cpu")
    eps = rng.uniform(0.1, 0.4, C).astype(np.float32)
    for kind, jm_, tm_ in (("diag", jm.StandardNormal(N), tm.StandardNormal(N, device="cpu")),
                           ("dense", jmodel, tmodel)):
        jpot, tpot = _metric(kind, rng, jmodel)
        jstart = _start(rng, jmodel, jpot)
        jv, jk = jnuts._make_batched_potential_ops(jpot)
        jout, jvel = jnuts._leapfrog_b(jv, jk, jax.vmap(jm_.logp_grad), jnp.asarray(eps),
                                       jstart)
        tv, tk = tnuts._make_batched_potential_ops(tpot)
        tout, tvel = tnuts._leapfrog_b(tv, tk, tm_.batched_logp_grad, torch.from_numpy(eps),
                                       phase_state_from_numpy(_np(jstart)))
        for name, got, want in zip(jnuts.PhaseState._fields + ("v",), tuple(tout) + (tvel,),
                                   tuple(jout) + (jvel,)):
            if kind == "diag" and name in ("q", "p", "q_grad", "v"):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
            else:
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                                           atol=2e-6, err_msg=f"{kind} {name}")


@pytest.mark.parametrize("check_extra", [False, True])
def test_merge_nodes_matches_jax(check_extra):
    """(a) merging two random subtrees (diag metric), the take2 decisions
    drawn from the same keys: the U-turn flags, the boundaries, the
    momentum sum and the proposal equal the JAX package's bit for bit; the
    log weights (``logaddexp``: each package's exp and log1p) within
    1e-6."""
    rng = np.random.default_rng(1 + check_extra)
    f32 = np.float32

    def node():
        return dict(left_p=rng.standard_normal((C, N)).astype(f32),
                    right_p=rng.standard_normal((C, N)).astype(f32), left_v=None,
                    right_v=None, p_sum=rng.standard_normal((C, N)).astype(f32),
                    q=rng.standard_normal((C, N)).astype(f32),
                    energy=rng.standard_normal(C).astype(f32),
                    logp=rng.standard_normal(C).astype(f32),
                    log_size=rng.uniform(-3, 3, C).astype(f32),
                    log_weighted_accept_sum=rng.uniform(-3, 3, C).astype(f32))

    t1, t2 = node(), node()
    var = rng.uniform(0.5, 2.0, (C, N)).astype(f32)
    keys = jax.random.split(jax.random.PRNGKey(7), C)

    def jnode(d):
        return jnuts.TreeNode(**{k: None if v is None else jnp.asarray(v) for k, v in d.items()})

    want, want_turn = jnuts._merge_nodes(keys, jnode(t1), jnode(t2), check_extra,
                                         lambda p: jnp.asarray(var) * p)
    tvar = torch.from_numpy(var)
    got, got_turn = tnuts._merge_nodes(JaxTreeRandom(), keys, tree_node_from_numpy(t1),
                                       tree_node_from_numpy(t2), check_extra,
                                       lambda p: tvar * p)
    np.testing.assert_array_equal(got_turn.numpy(), np.asarray(want_turn))
    assert 0 < int(got_turn.sum()) < C
    swapped = np.asarray(want.energy) == t2["energy"]
    assert 0 < swapped.sum() < C
    for k in jnuts.TreeNode._fields:
        w = getattr(want, k)
        if w is None:
            assert getattr(got, k) is None
        elif k in ("log_size", "log_weighted_accept_sum"):
            np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(w), err_msg=k)


# --------------------------------------------------------------------------
# (b) the whole tree
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["diag", "dense", "per_chain_dense"])
def test_run_nuts_tree_matches_jax_chain_for_chain(kind):
    """(b) one trajectory of 32 chains at tree depth up to 8 (a quarter of
    the chains capped at 6): every chain's depth, proposal count and
    divergence, turning and max-depth flags equal the JAX tree's, its
    proposal within 1e-5 relative, its proposal energy and accept
    statistic within 1e-4."""
    rng = np.random.default_rng({"diag": 3, "dense": 4, "per_chain_dense": 5}[kind])
    jmodel, tmodel = jm.CorrelatedGaussian(N), tm.CorrelatedGaussian(N, device="cpu")
    jpot, tpot = _metric(kind, rng, jmodel)
    jstart = _start(rng, jmodel, jpot)
    eps = rng.uniform(0.15, 0.45, C).astype(np.float32)
    mdc = np.full(C, D, np.int32)
    mdc[::4] = D - 2
    keys = jax.random.split(jax.random.PRNGKey(11), C)
    want = jnuts.run_nuts_tree(keys, jstart, jnp.asarray(eps), jnp.asarray(mdc), jpot,
                               jax.vmap(jmodel.logp_grad), JNUTSConfig(max_treedepth=D))
    got = tnuts.run_nuts_tree(JaxTreeRandom(), keys, phase_state_from_numpy(_np(jstart)),
                              torch.from_numpy(eps), torch.from_numpy(mdc), tpot,
                              tmodel.batched_logp_grad, NUTSConfig(max_treedepth=D))
    want = {k: np.asarray(v) for k, v in want._asdict().items()}
    got = {k: v.numpy() for k, v in got._asdict().items()}
    for k in TREE_FLAGS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert want["depth"].mean() > 2 and want["turning"].any()
    scale = np.abs(want["prop_q"]).max(1, keepdims=True)
    np.testing.assert_allclose(got["prop_q"] / scale, want["prop_q"] / scale, atol=1e-5, rtol=0)
    for k in ("prop_energy", "prop_logp", "mean_tree_accept", "max_energy_change"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)


# --------------------------------------------------------------------------
# (c) sample() on the tree
# --------------------------------------------------------------------------

PREC = np.linalg.inv(jm.CorrelatedGaussian(4, rho=0.5, scale_range=(0.5, 2.0)).cov)
TRUE_VAR = np.diag(np.linalg.inv(PREC))


def _jax_closure(q):
    g = -jnp.dot(jnp.asarray(PREC, jnp.float32), q)
    return 0.5 * jnp.dot(q, g), g


def _torch_closure(q):
    g = -torch.from_numpy(PREC.astype(np.float32)) @ q
    return 0.5 * (q * g).sum(), g


@pytest.fixture(scope="module", params=["closure", "per_chain_adapt_full"])
def tree_runs(request):
    """Both packages on the tensor-op tree, 32 chains, 300 tune + 300
    draws: a 4-d Gaussian given as a plain closure (adapt_diag), or the
    5-d correlated Gaussian with per-chain adapt_full."""
    kw = dict(chains=C, tune=300, draws=300, random_seed=4, progressbar=False)
    if request.param == "closure":
        n, jf, tf, init, true_var = 4, _jax_closure, _torch_closure, "jitter+adapt_diag", TRUE_VAR
    else:
        n, init = N, "jitter+adapt_full"
        jf, tf = jm.CorrelatedGaussian(N).logp_grad, tm.CorrelatedGaussian(N, device="cpu").logp_grad
        true_var = jm.CorrelatedGaussian(N).true_var
    jtr, jst = lmc.sample(logp_dlogp_func=jf, model_ndim=n, init=init,
                          step=lmc.NUTS(model_ndim=n, pallas_trajectory=None), **kw)
    report = {}
    ttr, tst = lt.sample(tf, model_ndim=n, init=init, device="cpu", perf_report=report, **kw)
    return (request.param, true_var, np.asarray(jtr), {k: np.asarray(v) for k, v in jst.items()},
            ttr, tst, report)


def test_tree_sample_matches_jax(tree_runs):
    """(c) the engine is the tree's; each package's posterior mean within
    4.5 Monte Carlo errors of 0, its variance within 15% of the truth; mean
    tree depth and accept statistic within 15% of each other; no
    divergences."""
    name, true_var, jtr, jst, ttr, tst, report = tree_runs
    want = "per_draw_dense" if name == "per_chain_adapt_full" else "per_draw_diag"
    assert report["engine"] == want and report["trajectory"] == "tensor"
    assert report["kernel_launches"] == {"nuts_trajectory": 0, "fused_nuts": 0}
    sd = np.sqrt(true_var)
    for tr in (jtr, ttr):
        assert tr.shape == (C, 300, len(true_var)) and np.isfinite(tr).all()
        for i in range(tr.shape[2]):
            se = sd[i] / np.sqrt(ess_bulk(tr[:, :, i]))
            assert abs(tr[:, :, i].mean()) < 4.5 * se, (i, tr[:, :, i].mean(), se)
        ratio = tr.reshape(-1, tr.shape[2]).var(0) / true_var
        assert np.all(np.abs(ratio - 1) < 0.15), ratio
    for k in ("depth", "mean_tree_accept"):
        j, t = jst[k].mean(), tst[k].mean()
        assert abs(t / j - 1) < 0.15, (k, t, j)
    assert tst["diverging"].sum() == 0 and jst["diverging"].sum() == 0


# --------------------------------------------------------------------------
# (d) the numpy-callable wrapper
# --------------------------------------------------------------------------

def _numpy_model(x):
    g = -PREC @ x
    return 0.5 * float(x @ g), g


def test_from_numpy_callable_matches_jax_and_samples():
    """(d) the wrapper gives the JAX wrapper's float32 numbers, one chain
    and a batch; ``sample`` runs it on the tree and its posterior variance
    is within 20% of the truth (16 chains, 150 + 150 draws)."""
    q = np.random.default_rng(6).standard_normal((8, 4)).astype(np.float32)
    jf, tf = j_from_numpy_callable(_numpy_model, 4), from_numpy_callable(_numpy_model, 4)
    jlp, jg = jax.vmap(jf)(jnp.asarray(q))
    tlp, tg = tf(torch.from_numpy(q))
    np.testing.assert_array_equal(tlp.numpy(), np.asarray(jlp))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    lp1, g1 = tf(torch.from_numpy(q[3]))
    assert lp1.shape == () and float(lp1) == float(jlp[3])
    report = {}
    trace, stats = lt.sample(tf, model_ndim=4, chains=16, tune=150, draws=150, random_seed=3,
                             device="cpu", perf_report=report, progressbar=False)
    assert report["engine"] == "per_draw_diag" and report["trajectory"] == "tensor"
    ratio = trace.reshape(-1, 4).var(0) / TRUE_VAR
    assert np.all(np.abs(ratio - 1) < 0.2), ratio


# --------------------------------------------------------------------------
# (e) the metrics no kernel takes
# --------------------------------------------------------------------------

def test_metrics_without_a_kernel_run_on_the_tree():
    """(e) a dense mass-matrix scaling (``QuadPotentialFullInv``) and
    per-chain adapt_full on a model with a kernel body run on the tree;
    ``fuse_draws=True`` refuses per-chain dense adaptation; the inverse
    metric's velocity is ``A^-1 p`` and its kinetic energy the JAX one's."""
    model = tm.CorrelatedGaussian(3, device="cpu")
    A = np.linalg.inv(model.cov)
    jpot, tpot = jqp.quad_potential(jnp.asarray(A, jnp.float32), False), \
        tqp.quad_potential(A, False)
    assert isinstance(tpot, tqp.QuadPotentialFullInv)
    p = np.random.default_rng(8).standard_normal(3).astype(np.float32)
    np.testing.assert_allclose(tpot.velocity(torch.from_numpy(p)).numpy(),
                               np.asarray(jpot.velocity(jnp.asarray(p))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tpot.kinetic(torch.from_numpy(p))),
                               float(jpot.kinetic(jnp.asarray(p))), rtol=1e-5)
    kw = dict(model_ndim=3, chains=16, tune=20, draws=10, random_seed=2, device="cpu",
              progressbar=False, compute_convergence_checks=False)
    for step_kw, init in ((dict(scaling=A, is_cov=False), "auto"), ({}, "adapt_full")):
        report = {}
        trace, stats = lt.sample(model.logp_grad, step=lt.NUTS(model_ndim=3, **step_kw),
                                 init=init, perf_report=report, **kw)
        assert report["engine"] == "per_draw_dense" and report["trajectory"] == "tensor"
        assert trace.shape == (16, 10, 3) and np.isfinite(trace).all()
    with pytest.raises(ValueError, match="fuse_draws=True"):
        lt.sample(model.logp_grad, init="adapt_full", fuse_draws=True, **kw)


@pytest.mark.parametrize("trajectory_spec", ["auto", None], ids=["kernel", "tree"])
def test_early_cap_above_max_treedepth_stops_at_max_treedepth(trajectory_spec):
    """``early_max_treedepth`` (8 by default) above ``max_treedepth``: the
    tree, as the trajectory kernel (``min(max_sched, D)``), stops at
    ``max_treedepth`` in the early window too, where its merge stack of
    ``max_treedepth`` slots would overflow; a tiny step size makes every
    tree reach the cap."""
    model = tm.CorrelatedGaussian(3, device="cpu")
    step = lt.NUTS(model_ndim=3, max_treedepth=3, adapt_step_size=False, step_scale=1e-4,
                   trajectory_spec=trajectory_spec)
    trace, stats = lt.sample(model.logp_grad, step=step, model_ndim=3, chains=16, tune=4,
                             draws=2, random_seed=2, device="cpu", progressbar=False,
                             discard_tuned_samples=False, compute_convergence_checks=False)
    assert stats["depth"].max() == 3 and (stats["tree_size"] == 7).all()
