"""The port's eight schools and the fused kernels' diag branch, held against
the JAX package on the CPU.

- (a) ``EightSchools`` logp and grad against ``littlemcmc_tpu.models.
  EightSchools``;
- (b) the NUTS trajectory op's plain version with the eight-schools body
  against ``build_trajectory_op(interpret=True, pack=1)``;
- (c) the HMC trajectory op's plain version against
  ``build_hmc_trajectory_op(interpret=True)``;
- (d) the fused NUTS op's plain version, ``metric="diag"``, against
  ``build_fused_nuts_op(metric="diag", interpret=True, pack=1)``: draw and
  tune chunks, with the per-chain Welford adaptation (``adapt_metric``) on
  and off, on eight schools and a 5-d correlated Gaussian;
- (e) the same for the fused HMC op;
- (f) ``sample()`` of both packages on eight schools, NUTS and HMC, both on
  their fused diag engines;
- (g) the engine election against the JAX package's.

Both packages draw the same counter streams, so (b)-(e) compare tree for
tree (NUTS) or chain for chain (HMC). The eight-schools body sums over the
ten columns in another order in each package (the JAX kernel over 128
padded lanes), and ``exp(log_tau)`` rounds alike; a rounding difference
near a U-turn, an accept threshold or the divergence bound can flip a
decision and, for NUTS, through the block's shared counter, the rest of
its block. So at least 99% of chain-draws must agree, and the numbers are
held on the chain-draws whose block (NUTS) or chain (HMC) agreed so far.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import littlemcmc_tpu as lmc
import littlemcmc_torch as lt
from littlemcmc_tpu import models as jm
from littlemcmc_tpu.base import HMCConfig as JHMCConfig
from littlemcmc_tpu.base import NUTSConfig as JNUTSConfig
from littlemcmc_tpu.ops import PallasModelSpec, build_trajectory_op
from littlemcmc_tpu.ops.fused_hmc_pallas import build_fused_hmc_op
from littlemcmc_tpu.ops.fused_nuts_pallas import build_fused_nuts_op
from littlemcmc_tpu.ops.hmc_trajectory_pallas import build_hmc_trajectory_op
from littlemcmc_tpu.ops.nuts_trajectory_pallas import padded_dim, resolve_pack
from littlemcmc_tpu.quadpotential import QuadPotentialDiagAdapt as JDiagAdapt
from littlemcmc_tpu.sampling import elect_fused_engine
from littlemcmc_tpu.step_sizes import DualAverageState as JDualAverage
from littlemcmc_tpu.step_sizes import dual_average_update
from littlemcmc_torch import models as tm
from littlemcmc_torch.base import HMCConfig, NUTSConfig
from littlemcmc_torch.ops.fused_hmc import fused_hmc
from littlemcmc_torch.ops.fused_nuts import WELFORD_KEYS, fused_nuts
from littlemcmc_torch.ops.hmc_trajectory import hmc_trajectory
from littlemcmc_torch.ops.nuts_trajectory import trajectory
from littlemcmc_torch.quadpotential import QuadPotentialDiagAdapt

from chip_smoke import _es_positions, _replay_diag_welford

torch.set_num_threads(1)

SEED = (246813579, -31)
FLAGS = ("depth", "n_leaves", "diverging", "turning")
HMC_FLAGS = ("n_steps", "accepted", "diverging")
DA_KEYS = ("da_log_step", "da_log_bar", "da_hbar", "da_count", "da_mu")
C, CB = 32, 8
# a rough posterior scale of eight schools: sd of mu, log_tau, theta_tilde
ES_SD = np.array([3.2, 3.4] + [1.0] * 8)


# --------------------------------------------------------------------------
# (a) the model
# --------------------------------------------------------------------------

def test_eight_schools_matches_jax_model():
    """(a) logp and grad at 16 points, batched and one chain at a time.
    rtol 1e-5, and 1e-6 absolute: a gradient near 0 (mu's, about 1e-3 at
    some points) is a sum of terms of size 1, each rounded at about 1e-7;
    the JAX model divides by sigma^2 where both kernels' bodies multiply
    by 1/sigma^2."""
    q = _es_positions(np.random.default_rng(0), 16)
    jmodel, tmodel = jm.EightSchools(), tm.EightSchools(device="cpu")
    lp, g = (np.asarray(x) for x in jmodel.batched_logp_grad(jnp.asarray(q)))
    tlp, tg = (x.numpy() for x in tmodel.batched_logp_grad(torch.from_numpy(q)))
    np.testing.assert_allclose(tlp, lp, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tg, g, rtol=1e-5, atol=1e-6)
    for i in range(16):
        lp1, g1 = tmodel.logp_grad(torch.from_numpy(q[i]))
        np.testing.assert_allclose(float(lp1), lp[i], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g1.numpy(), g[i], rtol=1e-5, atol=1e-6)
    assert tmodel.trajectory_spec().packable and tmodel.ndim == 10


def test_eight_schools_exact_moments():
    """The quadrature the card's gates use: mu 4.559 +- 3.204, log_tau
    -2.758 +- 3.432, within 1e-3 on a grid half as fine."""
    model = tm.EightSchools(device="cpu")
    m = model.exact_moments()
    np.testing.assert_allclose(m["mu"], (4.559, 3.204), atol=1e-3)
    np.testing.assert_allclose(m["log_tau"], (-2.758, 3.432), atol=1e-3)
    coarse = model.exact_moments((-40.0, 50.0, 901), (-35.0, 15.0, 1001))
    for k in m:
        np.testing.assert_allclose(coarse[k], m[k], atol=1e-3)


# --------------------------------------------------------------------------
# (b), (c) the per-draw trajectory ops with the eight-schools body
# --------------------------------------------------------------------------

def _diag_inputs(rng, C, eps):
    """Positions, an inverse-mass diagonal near the posterior variances,
    p ~ N(0, M), step sizes around ``eps``."""
    q = _es_positions(rng, C)
    var = (ES_SD ** 2 * rng.uniform(0.5, 2.0, (C, 10))).astype(np.float32)
    p = (rng.standard_normal((C, 10)) / np.sqrt(var)).astype(np.float32)
    eps = (eps * rng.uniform(0.7, 1.3, C)).astype(np.float32)
    lp, g = (np.asarray(x) for x in jm.EightSchools().batched_logp_grad(jnp.asarray(q)))
    return q, p, var, eps, lp, g


def test_trajectory_plain_matches_jax_eight_schools():
    """(b) one NUTS transition of 64 chains in blocks of 8: at least 99%
    of chains agree on every flag; on those, q within 1e-5 of its
    posterior scale and energies within 1e-4 relative (fp32 sums of ten
    terms in two orders, through up to 2^8 leapfrog steps)."""
    n, Cn, D = 10, 64, 8
    q, p, var, eps, lp, g = _diag_inputs(np.random.default_rng(1), Cn, 0.3)
    mdc = np.full(Cn, D, np.int32)
    mdc[::5] = D - 2
    op = build_trajectory_op(jm.EightSchools().pallas_trajectory_spec(), n, D, 1000.0,
                             interpret=True, chain_block=CB, pack=1)
    want = jax.tree.map(np.asarray, op(q, p, g, lp, eps, mdc, var,
                                       jnp.asarray(SEED, jnp.int32)))
    t = [torch.from_numpy(np.array(x)) for x in (q, p, g, lp, eps, mdc, var)]
    launches = trajectory.launches
    got = trajectory(*t, SEED, spec=tm.EightSchools(device="cpu").trajectory_spec(),
                     max_treedepth=D, Emax=1000.0, chain_block=CB)
    assert trajectory.launches == launches  # the CPU runs the plain version
    got = {k: v.numpy() for k, v in got.items()}
    agree = np.all([got[k] == want[k] for k in FLAGS], axis=0)
    assert agree.mean() >= 0.99, agree
    assert want["depth"].mean() > 2
    np.testing.assert_allclose(got["q"][agree] / ES_SD, want["q"][agree] / ES_SD, atol=1e-5,
                               rtol=0)
    for k in ("energy", "logp", "log_size"):
        np.testing.assert_allclose(got[k][agree], want[k][agree], atol=1e-4, rtol=1e-4)


def test_trajectory_plain_matches_jax_eight_schools_to_deeper_merges():
    """(b) one NUTS transition of 64 chains in blocks of 8 at a smaller
    step, so that trees run deeper: the cap of 8, mean depth above 3, so
    that a block's merges reach the upper slots of the stack (which the
    card's block transition keeps in shared memory) and the subtrees'
    U-turn checks span several levels; a quarter of the chains in the
    funnel's neck. The tolerances of the test above."""
    n, Cn, D = 10, 64, 8
    q, p, var, eps, lp, g = _diag_inputs(np.random.default_rng(7), Cn, 0.08)
    mdc = np.full(Cn, D, np.int32)
    mdc[::5] = D - 2
    op = build_trajectory_op(jm.EightSchools().pallas_trajectory_spec(), n, D, 1000.0,
                             interpret=True, chain_block=CB, pack=1)
    want = jax.tree.map(np.asarray, op(q, p, g, lp, eps, mdc, var,
                                       jnp.asarray(SEED, jnp.int32)))
    t = [torch.from_numpy(np.array(x)) for x in (q, p, g, lp, eps, mdc, var)]
    got = trajectory(*t, SEED, spec=tm.EightSchools(device="cpu").trajectory_spec(),
                     max_treedepth=D, Emax=1000.0, chain_block=CB)
    got = {k: v.numpy() for k, v in got.items()}
    agree = np.all([got[k] == want[k] for k in FLAGS], axis=0)
    assert agree.mean() >= 0.99, agree
    assert want["depth"].mean() > 3 and want["depth"].max() >= 6, want["depth"]
    np.testing.assert_allclose(got["q"][agree] / ES_SD, want["q"][agree] / ES_SD, atol=1e-5,
                               rtol=0)
    for k in ("energy", "logp", "log_size"):
        np.testing.assert_allclose(got[k][agree], want[k][agree], atol=1e-4, rtol=1e-4)


def test_hmc_trajectory_plain_matches_jax_eight_schools():
    """(c) one HMC transition of 32 chains with step counts 1 to 40: every
    chain agrees on its accept and divergence; q within 1e-4 of its
    posterior scale (up to 40 leapfrog steps, some through the funnel's
    neck, where the gradient of log_tau is large, carry the rounding of the
    sums), the energies of the chains that did not diverge as the comment
    below says."""
    q, p, var, eps, lp, g = _diag_inputs(np.random.default_rng(2), C, 0.25)
    n_steps = np.random.default_rng(3).integers(1, 41, C).astype(np.int32)
    op = build_hmc_trajectory_op(jm.EightSchools().pallas_trajectory_spec(), 10, 1000.0,
                                 interpret=True, chain_block=CB)
    want = jax.tree.map(np.asarray, op(q, p, g, lp, eps, n_steps, var,
                                       jnp.asarray(SEED, jnp.int32)))
    t = [torch.from_numpy(np.array(x)) for x in (q, p, g, lp, eps, n_steps, var)]
    launches = hmc_trajectory.launches
    got = hmc_trajectory(*t, SEED, spec=tm.EightSchools(device="cpu").trajectory_spec(),
                         Emax=1000.0, chain_block=CB)
    assert hmc_trajectory.launches == launches
    got = {k: v.numpy() for k, v in got.items()}
    agree = (got["accepted"] == want["accepted"]) & (got["diverging"] == want["diverging"])
    assert agree.all(), agree
    assert 0 < want["accepted"].sum() < C
    np.testing.assert_allclose(got["q"] / ES_SD, want["q"] / ES_SD, atol=1e-4, rtol=0)
    # a divergent trajectory's end energy (up to 2e4 here) is a chaotic
    # integration's, whose rounding grows from step to step: held on the
    # chains that did not diverge. Long paths through the neck are
    # sensitive too: on one 39-step chain both fp32 versions end 5e-3 from
    # a float64 run. So the median chain within 1e-6 of the energy's and
    # the energy change's size, every chain within 1e-3 of it
    calm = ~want["diverging"]
    assert calm.mean() >= 0.5
    size = 1.0 + np.abs(want["energy"]) + np.abs(want["energy_change"])
    for k in ("logp", "logp_end", "energy", "energy_change"):
        rel = (np.abs(got[k] - want[k]) / size)[calm]
        assert np.median(rel) <= 1e-6 and rel.max() <= 1e-3, (k, rel.max())


# --------------------------------------------------------------------------
# (d), (e) the fused ops' diag branch
# --------------------------------------------------------------------------

def _correlated_spec(jmodel, n):
    """The JAX correlated Gaussian's kernel body in full float32."""
    prec = np.zeros((padded_dim(n),) * 2, np.float32)
    prec[:n, :n] = jmodel.prec.astype(np.float32)

    def fn(q, pm):
        g = -jnp.dot(q, pm, precision="highest", preferred_element_type=jnp.float32)
        return 0.5 * jnp.sum(q * g, axis=1, keepdims=True), g

    return PallasModelSpec(fn, (jnp.asarray(prec),), n)


@pytest.fixture(scope="module")
def fused_models():
    """Per model: the JAX model, its kernel body, the port's model and a
    posterior scale."""
    cg = jm.CorrelatedGaussian(5, rho=0.6)
    return {
        "eight_schools": (jm.EightSchools(), jm.EightSchools().pallas_trajectory_spec(),
                          tm.EightSchools(device="cpu"), ES_SD),
        "correlated": (cg, _correlated_spec(cg, 5),
                       tm.CorrelatedGaussian(5, rho=0.6, device="cpu"), np.sqrt(cg.true_var)),
    }


def _fused_inputs(model, sd, step, seed):
    """Positions near the posterior, a diag metric near its variances,
    dual averaging part way through tuning, and a per-chain Welford state
    whose windows swap at draw 2 (n_samples 48, window 50)."""
    rng = np.random.default_rng(seed)
    n = model.ndim
    if n == 10:
        q = _es_positions(rng, C)
    else:
        q = (rng.standard_normal((C, n)) @ np.linalg.cholesky(model.cov).T).astype(np.float32)
    lp, g = (np.asarray(x) for x in jax.vmap(model.logp_grad)(jnp.asarray(q)))
    f = np.float32
    ls = (np.log(step) + rng.uniform(-0.1, 0.1, C)).astype(f)
    x = dict(q=q, grad=g, logp=lp, iter_count=np.full(C, 250.0, f), da_log_step=ls,
             da_log_bar=ls.copy(), da_hbar=np.zeros(C, f), da_count=np.full(C, 40.0, f),
             da_mu=(ls + np.log(10.0)).astype(f),
             var=(sd ** 2 * rng.uniform(0.5, 2.0, (C, n))).astype(f))
    w = dict(fg_mean=(sd * rng.standard_normal((C, n)) * 0.3).astype(f),
             fg_raw=(40.0 * sd ** 2 * rng.uniform(0.5, 2.0, (C, n))).astype(f),
             fg_w=np.full(C, 40.0, f), fg_w2=np.full(C, 40.0, f),
             bg_mean=(sd * rng.standard_normal((C, n)) * 0.3).astype(f),
             bg_raw=(8.0 * sd ** 2 * rng.uniform(0.5, 2.0, (C, n))).astype(f),
             bg_w=np.full(C, 8.0, f), bg_w2=np.full(C, 8.0, f),
             n_samples=np.full(C, 48.0, f), window=np.full(C, 50.0, f))
    return x, tuple(w[k] for k in WELFORD_KEYS)


def _run_fused(fused_models, sampler, model_name, T, tuning, adapt_metric, adapt_step):
    jmodel, jspec, tmodel, sd = fused_models[model_name]
    x, welford = _fused_inputs(jmodel, sd, 0.45 if sampler == "hmc" else 0.6, seed=T + 7)
    welford = welford if adapt_metric else None
    keys = ("q", "grad", "logp", "iter_count") + DA_KEYS
    if sampler == "nuts":
        jcfg, cfg, build, op = (JNUTSConfig(adapt_step_size=adapt_step),
                                NUTSConfig(adapt_step_size=adapt_step), build_fused_nuts_op,
                                fused_nuts)
    else:
        jcfg, cfg, build, op = (JHMCConfig(adapt_step_size=adapt_step),
                                HMCConfig(adapt_step_size=adapt_step), build_fused_hmc_op,
                                fused_hmc)
    jop = build(jspec, jmodel.ndim, T, tuning, adapt_metric, jcfg, window_multiplier=2.0,
                chain_block=CB, interpret=True, pack=1, metric="diag")
    want = jop(*(jnp.asarray(x[k]) for k in keys), jnp.asarray(x["var"]),
               None if welford is None else tuple(map(jnp.asarray, welford)),
               jnp.asarray(SEED, jnp.int32))
    want = {k: np.asarray(v) for k, v in want.items() if v is not None}
    t = {k: torch.from_numpy(np.array(v)) for k, v in x.items()}
    launches = op.launches
    got = op(*(t[k] for k in keys), t["var"], None, SEED, spec=tmodel.trajectory_spec(), T=T,
             tuning=tuning, config=cfg, metric="diag", window_multiplier=2.0, chain_block=CB,
             welford=None if welford is None else tuple(map(torch.from_numpy, welford)))
    assert op.launches == launches  # the CPU runs the plain version
    got = {k: v.numpy() for k, v in got.items() if v is not None}
    assert set(got) == set(want)
    return x, welford, got, want


def _held(got, want, sampler):
    """Per (draw, chain): the flags agree, and the chain-draws held number
    for number: every chain of the block (NUTS: one counter stream a
    block) or the chain itself (HMC) agreed at this draw and all earlier
    ones."""
    flags = FLAGS if sampler == "nuts" else HMC_FLAGS
    agree = np.all([got[k] == want[k] for k in flags], axis=0)  # (T, C)
    unit = CB if sampler == "nuts" else 1
    block = agree.reshape(agree.shape[0], -1, unit).all(-1)
    return agree, np.repeat(np.cumprod(block, axis=0).astype(bool), unit, axis=1)


FUSED_CASES = [
    ("eight_schools", 4, False, False, True),
    ("eight_schools", 4, False, True, True),
    ("eight_schools", 8, True, True, False),
    ("eight_schools", 6, True, True, True),
    ("correlated", 8, True, True, False),
    ("correlated", 4, True, False, False),
]
FUSED_IDS = ["es_draw_static", "es_draw_adaptive", "es_tune_welford", "es_tune_adapting",
             "cg_tune_welford", "cg_tune_static"]


@pytest.mark.parametrize("sampler", ["nuts", "hmc"])
@pytest.mark.parametrize("model_name,T,tuning,adapt_metric,adapt_step", FUSED_CASES,
                         ids=FUSED_IDS)
def test_fused_diag_plain_matches_jax_op(fused_models, sampler, model_name, T, tuning,
                                         adapt_metric, adapt_step):
    """(d), (e) the fused op's diag branch against the JAX op, chain-draw
    for chain-draw. At least 99% of chain-draws agree on every flag (with
    the step size adapting, the first draw: dual averaging carries each
    draw's rounding into the next draw's step size). On the held
    chain-draws: the trace within 1e-4 of the posterior scale, the
    energies within 1e-4 of their and the energy change's size (the
    largest energy change of a tree where it did not diverge), the accept
    statistic within that
    relative, the step sizes within 1e-5 relative (held step) or within
    what dual averaging makes of the accept statistic's difference. At
    the end of the chunk, on the chains held throughout (step size held):
    the state, the metric ``var`` and the Welford rows within 1e-4 relative
    (1e-4 of the scale absolute) and the weights and counters exactly; and
    in tune chunks ``var`` and the Welford state within 1e-4 of a float64
    replay of the op's own trace, every chain."""
    jmodel, _, _, sd = fused_models[model_name]
    x, welford, got, want = _run_fused(fused_models, sampler, model_name, T, tuning,
                                       adapt_metric, adapt_step)
    agree, held = _held(got, want, sampler)
    adapting = tuning and adapt_step
    checked = agree[:1] if adapting else agree
    assert checked.mean() >= 0.99, agree
    if adapting:
        held[1:] = False
    assert held.mean() >= (0.1 if adapting else 0.5)
    np.testing.assert_allclose(got["trace"][held] / sd, want["trace"][held] / sd, atol=1e-4,
                               rtol=0)
    # a proposal far from the start's energy (|energy_error| up to 60
    # here) ends a trajectory the step size makes unstable, whose rounding
    # grows from step to step: 1e-4 of the energy's and the energy
    # change's size
    e_tol = 1e-4 * (1.0 + np.abs(want["energy"][held]) + np.abs(want["energy_error"][held]))
    for k in ("energy", "model_logp", "energy_error"):
        assert (np.abs(got[k] - want[k])[held] <= e_tol).all(), k
    if sampler == "nuts":
        # the largest energy change of a tree in size (two leaves a rounding
        # apart in size and opposite in sign swap), so also within 1e-4 of
        # that size; a divergent leaf's (up to 1e18 here) is a chaotic
        # trajectory's: both exceed Emax
        calm = ~want["diverging"][held]
        mec_g = np.abs(got["max_energy_change"][held])
        mec_w = np.abs(want["max_energy_change"][held])
        assert (np.abs(mec_g - mec_w) <= e_tol + 1e-4 * mec_w)[calm].all()
        assert (mec_g[~calm] >= 1000.0).all() and (mec_w[~calm] >= 1000.0).all()
    else:
        np.testing.assert_array_equal(got["path_length"], want["path_length"])
    acc = "mean_tree_accept" if sampler == "nuts" else "accept"
    d_acc = np.abs(got[acc] - want[acc])
    assert (d_acc[held] <= 2 * e_tol * want[acc][held] + 1e-7).all(), d_acc[held].max()
    cnt = x["da_count"][None, :] + np.arange(T)[:, None]
    cfg = (JNUTSConfig if sampler == "nuts" else JHMCConfig)()
    lim = 1e-5 + (np.sqrt(cnt) / (cfg.gamma * (cnt + cfg.t0)) * d_acc if adapting else 0.0)
    for k in ("step_size", "step_size_bar"):
        rel = np.abs(got[k] - want[k]) / want[k]
        assert (rel <= lim)[held].all(), k
    if adapting:
        da = JDualAverage(*(jnp.asarray(x[k]) for k in DA_KEYS[:3]),
                          count=jnp.asarray(x["da_count"]).astype(jnp.int32),
                          mu=jnp.asarray(x["da_mu"]))
        for t in range(T):
            da = dual_average_update(da, jnp.asarray(got[acc][t]), True,
                                     target=cfg.target_accept, gamma=cfg.gamma, k=cfg.k,
                                     t0=cfg.t0)
        for k, want_k in zip(DA_KEYS, (da.log_step, da.log_bar, da.hbar, da.count, da.mu)):
            np.testing.assert_allclose(got[k], np.asarray(want_k, np.float32), rtol=1e-5,
                                       atol=1e-6)
    else:
        end = held[-1]
        for k in DA_KEYS + ("iter_count", "logp"):
            np.testing.assert_allclose(got[k][end], want[k][end], rtol=1e-5, atol=1e-4)
    if not adapt_metric:
        return
    if not adapting:
        end = held[-1]  # the chains held through the chunk
        assert end.mean() >= 0.5
        for k in ("var",) + WELFORD_KEYS:
            g_, w_ = got[k][end], want[k][end]
            if g_.ndim == 2:
                scale = sd ** 2 if k in ("var", "fg_raw", "bg_raw") else sd
                scale = scale * (want["fg_w"][end][:, None] if k.endswith("raw") else 1.0)
                np.testing.assert_allclose(g_ / scale, w_ / scale, rtol=1e-4, atol=1e-4)
            else:
                np.testing.assert_array_equal(g_, w_)
    if not tuning:
        np.testing.assert_array_equal(got["var"], x["var"])  # draw chunks pass it through
        return
    var, s = _replay_diag_welford(tuple(map(torch.from_numpy, welford)),
                                  torch.from_numpy(got["trace"]))
    np.testing.assert_allclose(got["var"], var.numpy(), rtol=1e-4, atol=1e-6)
    for k in WELFORD_KEYS:
        np.testing.assert_allclose(got[k], s[k].numpy(), rtol=1e-4, atol=1e-5)
    assert (got["n_samples"] == 48.0 + T).all() and (got["window"] == 100.0).all()


# --------------------------------------------------------------------------
# (f) sample() of both packages
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["nuts", "hmc"])
def slice_runs(request):
    """Both packages on eight schools, 32 chains, 150 tune + 150 draws,
    target_accept 0.95, each on its fused diag engine (the JAX package's
    kernels under interpret=True)."""
    jmodel = jm.EightSchools()
    kw = dict(model_ndim=10, chains=C, tune=150, draws=150, random_seed=5, progressbar=False,
              return_final_state=True)
    if request.param == "nuts":
        jstep = lmc.NUTS(model_ndim=10, target_accept=0.95,
                         pallas_trajectory=jmodel.pallas_trajectory_spec(),
                         pallas_interpret=True)
        tstep = lt.NUTS(model_ndim=10, target_accept=0.95)
    else:
        jstep = lmc.HamiltonianMC(model_ndim=10, target_accept=0.95,
                                  pallas_trajectory=jmodel.pallas_trajectory_spec(),
                                  pallas_interpret=True)
        tstep = lt.HamiltonianMC(model_ndim=10, target_accept=0.95)
    jreport, treport = {}, {}
    jrun = lmc.sample(logp_dlogp_func=jmodel.logp_grad, step=jstep, fuse_draws=True,
                      perf_report=jreport, **kw)
    trun = lt.sample(tm.EightSchools(device="cpu").logp_grad, step=tstep, device="cpu",
                     perf_report=treport, **kw)
    assert jreport["engine"] == treport["engine"] == "fused_diag"
    return request.param, jrun, trun


def test_slice_matches_jax_sample(slice_runs):
    """(f) the adapted step sizes within 35% of each other (two short runs
    of 32 chains whose trees differ from the first divergence on); the
    Welford counters exactly (both count every tune draw: the same window
    swaps); mu within Monte Carlo error of the exact posterior mean (4.5
    standard errors from the run's bulk ESS); few divergences."""
    from littlemcmc_torch.utils.diagnostics import ess_bulk

    sampler, (jtr, jst, jfs), (ttr, tst, tfs) = slice_runs
    step_j = float(np.exp(np.asarray(jfs.da.log_bar)).mean())
    step_t = float(torch.exp(tfs.da.log_bar).mean())
    assert abs(np.log(step_t / step_j)) < np.log(1.35), (step_t, step_j)
    assert isinstance(tfs.potential, QuadPotentialDiagAdapt)
    assert isinstance(jfs.potential, JDiagAdapt)
    for k in ("n_samples", "window"):
        np.testing.assert_array_equal(getattr(tfs.potential, k).numpy(),
                                      np.asarray(getattr(jfs.potential, k)))
    np.testing.assert_array_equal(tfs.potential.fg.w_sum.numpy(),
                                  np.asarray(jfs.potential.fg.w_sum))
    mu_mean, mu_sd = tm.EightSchools(device="cpu").exact_moments()["mu"]
    for tr in (np.asarray(jtr), ttr):
        se = mu_sd / np.sqrt(ess_bulk(tr[:, :, 0]))
        assert abs(tr[:, :, 0].mean() - mu_mean) < 4.5 * se, (tr[:, :, 0].mean(), se)
    assert tst["diverging"].mean() < (0.04 if sampler == "nuts" else 0.02)


# --------------------------------------------------------------------------
# (g) the engine election
# --------------------------------------------------------------------------

ELECTION_CASES = [
    ("eight_schools", 32, None, None), ("eight_schools", 32, False, None),
    ("eight_schools", 24, None, None), ("eight_schools", 16, None, True),
    ("eight_schools", 4, None, None), ("standard_normal", 64, None, None),
    ("standard_normal", 8, None, None), ("correlated", 32, None, None),
    ("correlated", 32, True, None), ("correlated", 32, True, True),
]


@pytest.mark.parametrize("model_name,chains,fuse_draws,cross_chain_adapt", ELECTION_CASES)
def test_engine_election_matches_jax(model_name, chains, fuse_draws, cross_chain_adapt):
    """(g) the port's engine for the diagonal metric is the one
    ``elect_fused_engine`` and ``resolve_pack`` (and the chain-count rule)
    pick for the same model and chain count; ``fuse_draws=True`` forces
    the fused one; the stats have the reference's shapes."""
    from littlemcmc_tpu.ops.nuts_trajectory_pallas import usable_chain_count

    n = {"eight_schools": 10, "standard_normal": 4, "correlated": 3}[model_name]
    jspec = {"eight_schools": jm.EightSchools().pallas_trajectory_spec(),
             "standard_normal": jm.StandardNormal(n).pallas_trajectory_spec(),
             "correlated": jm.CorrelatedGaussian(n).pallas_trajectory_spec()}[model_name]
    tmodel = {"eight_schools": tm.EightSchools(device="cpu"),
              "standard_normal": tm.StandardNormal(n, device="cpu"),
              "correlated": tm.CorrelatedGaussian(n, device="cpu")}[model_name]
    pooled = bool(cross_chain_adapt)
    jax_fused = usable_chain_count(chains, 256) and (
        fuse_draws is True or (fuse_draws is None and elect_fused_engine(
            "diag", pooled, resolve_pack(jspec, n, chains))))
    want = ("fused_" if jax_fused else "per_draw_") + "diag" + ("_pooled" if pooled else "")
    report = {}
    trace, stats = lt.sample(tmodel.logp_grad, model_ndim=n, chains=chains, tune=6, draws=3,
                             random_seed=2, device="cpu", fuse_draws=fuse_draws,
                             cross_chain_adapt=cross_chain_adapt, perf_report=report,
                             progressbar=False, compute_convergence_checks=False)
    assert report["engine"] == want
    assert report["kernel_launches"] == {"nuts_trajectory": 0, "fused_nuts": 0}
    assert trace.shape == (chains, 3, n) and np.isfinite(trace).all()
    assert all(v.shape == (chains, 3) for v in stats.values())


def test_fuse_draws_true_raises_where_the_fused_kernels_do_not_run():
    """``fuse_draws=True`` at a chain count that does not block into chain
    blocks of 8, as the JAX package refuses it (``sampling.py:1339-1349``)."""
    model = tm.EightSchools(device="cpu")
    with pytest.raises(ValueError, match="fuse_draws=True"):
        lt.sample(model.logp_grad, model_ndim=10, chains=4, tune=4, draws=2, device="cpu",
                  fuse_draws=True, progressbar=False)
