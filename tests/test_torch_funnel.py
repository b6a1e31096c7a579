"""The port's Neal's funnel (BASELINE config 3) and the kernels' funnel body
(body 5), held against the JAX package on the CPU.

- (a) ``NealsFunnel`` and ``NonCenteredFunnel`` logp and grad against
  ``littlemcmc_tpu.models`` at the same q (v in [-6, 6]), and
  ``NonCenteredFunnel.transform``;
- (b) body 5's plain version against the JAX spec's ``fn``;
- (c) the NUTS and HMC trajectory ops' plain versions with the funnel body
  against ``build_trajectory_op`` / ``build_hmc_trajectory_op`` under
  ``interpret=True`` (``pack=1``);
- (d) the fused NUTS and HMC ops' plain versions, ``metric="diag"``, against
  the JAX fused ops under ``interpret=True``;
- (e) the engine election against the JAX package's table;
- (f) ``sample()`` of both packages on each form.

The JAX spec's body sums ``q.q - v^2`` for ``sum_{i>=1} x_i^2``; the port's
sums the x columns alone (the cancellation is what makes float32 chaotic in
the neck, ``v < -2``, where ``v^2`` dwarfs the sum): in the neck the JAX
form is off by up to about ``v^2 2^-24`` in ``sq``, which ``exp(-v)``
multiplies. (b) holds the JAX spec's ``fn`` within that; (c) and (d) run
the JAX ops with the JAX body in the port's sum (``_jax_spec``), so the
two differ only in summation order (``warp_sum`` against ``jnp.sum`` over
128 lanes). The neck still multiplies a rounding difference by up to
``e^6``, so a tree there can take another decision and, for NUTS, through
the block's shared counter, change the rest of its block: at least 99% of
chains (chain-draws) agree on every flag, as for eight schools; the numbers
are held on the chains (blocks, for NUTS) that agree so far, the energies
within 1e-4 of their and the energy change's size (``scaled``, as for
eight schools), divergent ones not.
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
from littlemcmc_tpu.ops import build_trajectory_op
from littlemcmc_tpu.ops.fused_hmc_pallas import build_fused_hmc_op
from littlemcmc_tpu.ops.fused_nuts_pallas import build_fused_nuts_op
from littlemcmc_tpu.ops.hmc_trajectory_pallas import build_hmc_trajectory_op
from littlemcmc_tpu.ops.nuts_trajectory_pallas import padded_dim, resolve_pack
from littlemcmc_tpu.sampling import elect_fused_engine
from littlemcmc_torch import models as tm
from littlemcmc_torch.base import HMCConfig, NUTSConfig
from littlemcmc_torch.ops.fused_hmc import fused_hmc
from littlemcmc_torch.ops.fused_nuts import WELFORD_KEYS, fused_nuts
from littlemcmc_torch.ops.hmc_trajectory import hmc_trajectory
from littlemcmc_torch.ops.nuts_trajectory import body_logp_grad, trajectory
from littlemcmc_torch.sampling import _resolve_pack

from chip_smoke import _funnel_positions

torch.set_num_threads(1)

SEED = (135792468, -77)
FLAGS = ("depth", "n_leaves", "diverging", "turning")
HMC_FLAGS = ("n_steps", "accepted", "diverging")
DA_KEYS = ("da_log_step", "da_log_bar", "da_hbar", "da_count", "da_mu")
N, C, CB = 10, 32, 8
SD = np.sqrt(jm.NealsFunnel(N).true_var)  # the marginal posterior sds


def _jax_spec():
    """The JAX funnel body with the port's sum, ``sq`` over the x columns
    alone (the padding columns are zero): the ops below are held against
    the JAX ops' transition machinery in the port's arithmetic, and (b)
    holds the JAX spec's own ``fn`` apart."""
    from jax import lax
    from littlemcmc_tpu.ops import PallasModelSpec

    inv_s2, nx = 1.0 / 9.0, float(N - 1)

    def fn(q):
        col = lax.broadcasted_iota(jnp.int32, q.shape, 1)
        v = q[:, 0:1]
        e = jnp.exp(-v)
        sq = jnp.sum(jnp.where(col >= 1, q * q, 0.0), axis=1, keepdims=True)
        logp = -0.5 * inv_s2 * v * v - 0.5 * nx * v - 0.5 * sq * e
        dv = -inv_s2 * v - 0.5 * nx + 0.5 * sq * e
        return logp, jnp.where(col == 0, dv, -q * e)

    return PallasModelSpec(fn, (), N)


def _positions(seed, C, vs=None):
    rng = np.random.default_rng(seed)
    q = _funnel_positions(rng, C, N)
    if vs is not None:
        q[:, 0] = vs
        q[:, 1:] = rng.standard_normal((C, N - 1)) * np.exp(vs / 2.0)[:, None]
    return q.astype(np.float32)


# --------------------------------------------------------------------------
# (a), (b) the models and the body
# --------------------------------------------------------------------------

def test_funnels_match_jax_models():
    """(a) logp and grad at 25 points with v from -6 to 6, batched and one
    chain at a time: rtol 1e-5, and 1e-6 of the gradient's size absolute
    (v's gradient sums terms of opposite sign); ``true_mean``/``true_var``
    equal; ``transform`` equal within float32 rounding."""
    q = _positions(0, 25, np.linspace(-6.0, 6.0, 25))
    for jmodel, tmodel in ((jm.NealsFunnel(N), tm.NealsFunnel(N, device="cpu")),
                           (jm.NonCenteredFunnel(N), tm.NonCenteredFunnel(N, device="cpu"))):
        lp, g = (np.asarray(x) for x in jmodel.batched_logp_grad(jnp.asarray(q)))
        tlp, tg = (x.numpy() for x in tmodel.batched_logp_grad(torch.from_numpy(q)))
        np.testing.assert_allclose(tlp, lp, rtol=1e-5, atol=1e-6)
        gsize = 1e-6 * (1.0 + np.abs(g).max(1, keepdims=True))
        assert (np.abs(tg - g) <= 1e-5 * np.abs(g) + gsize).all()
        for i in range(0, 25, 6):
            lp1, g1 = tmodel.logp_grad(torch.from_numpy(q[i]))
            np.testing.assert_allclose(float(lp1), lp[i], rtol=1e-5, atol=1e-6)
            assert (np.abs(g1.numpy() - g[i]) <= 1e-5 * np.abs(g[i]) + gsize[i]).all()
        np.testing.assert_array_equal(tmodel.true_mean, jmodel.true_mean)
        np.testing.assert_array_equal(tmodel.true_var, jmodel.true_var)
        assert tmodel.trajectory_spec().packable
    ncf_j, ncf_t = jm.NonCenteredFunnel(N), tm.NonCenteredFunnel(N, device="cpu")
    want = np.asarray(ncf_j.transform(jnp.asarray(q)))
    np.testing.assert_allclose(ncf_t.transform(torch.from_numpy(q)).numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(ncf_t.transform(q), want, rtol=1e-6)
    assert tm.NealsFunnel(N, device="cpu").trajectory_spec().body == "funnel"
    assert ncf_t.trajectory_spec().body == "standard_normal"


def test_funnel_body_matches_jax_spec_fn():
    """(b) body 5's plain version against the JAX spec's ``fn`` at 64
    points, v from -6 to 6. Off the neck (v >= -2): rtol 1e-5, and 1e-6 of
    the size of the logp's and gradient's terms absolute. In the neck the
    JAX form's ``sq = q.q - v^2`` carries an error up to ``4 v^2 2^-24``,
    which ``exp(-v)`` scales: held within that."""
    q = _positions(1, 64, np.linspace(-6.0, 6.0, 64))
    spec = jm.NealsFunnel(N).pallas_trajectory_spec()
    qp = np.zeros((64, padded_dim(N)), np.float32)
    qp[:, :N] = q
    lp, g = (np.asarray(x) for x in jax.jit(spec.fn)(jnp.asarray(qp), *spec.consts))
    lp, g = lp[:, 0], g[:, :N]
    tlp, tg = (x.numpy() for x in body_logp_grad(
        tm.NealsFunnel(N, device="cpu").trajectory_spec(), torch.from_numpy(q)))
    v = q[:, 0].astype(np.float64)
    sq = (q[:, 1:].astype(np.float64) ** 2).sum(1)
    e = np.exp(-v)
    size = np.abs(v) ** 2 / 18.0 + 4.5 * np.abs(v) + 0.5 * sq * e  # the logp's terms
    cancel = 4.0 * v ** 2 * 2.0 ** -24 * 0.5 * e  # the JAX form's error in sq, scaled
    tol = 1e-5 * np.abs(lp) + 1e-6 * size + np.where(v < -2, cancel, 0.0)
    assert (np.abs(tlp - lp) <= tol).all(), np.abs(tlp - lp) / tol
    tol_g = 1e-5 * np.abs(g) + 1e-6 * size[:, None] + np.where(v < -2, cancel, 0.0)[:, None]
    assert (np.abs(tg - g) <= tol_g).all()


# --------------------------------------------------------------------------
# (c) the per-draw trajectory ops
# --------------------------------------------------------------------------

def _diag_inputs(seed, C, eps):
    rng = np.random.default_rng(seed)
    q = _positions(seed, C)
    var = (np.array([9.0] + [1.0] * (N - 1)) * rng.uniform(0.5, 2.0, (C, N))).astype(np.float32)
    p = (rng.standard_normal((C, N)) / np.sqrt(var)).astype(np.float32)
    eps = (eps * rng.uniform(0.7, 1.3, C)).astype(np.float32)
    lp, g = (np.asarray(x) for x in jm.NealsFunnel(N).batched_logp_grad(jnp.asarray(q)))
    return q, p, var, eps, lp, g


def _agreement(agree):
    assert agree.mean() >= 0.99, agree.mean()


def test_trajectory_plain_matches_jax_funnel():
    """(c) one NUTS transition of 64 chains in blocks of 8 (a quarter
    starting in the neck): flags as the module docstring says; on the
    blocks that agree, q within 1e-5 of its marginal sd and the energies
    within 1e-4 of their size."""
    D = 8
    q, p, var, eps, lp, g = _diag_inputs(2, 64, 0.2)
    mdc = np.full(64, D, np.int32)
    op = build_trajectory_op(_jax_spec(), N, D, 1000.0,
                             interpret=True, chain_block=CB, pack=1)
    want = jax.tree.map(np.asarray, op(q, p, g, lp, eps, mdc, var,
                                       jnp.asarray(SEED, jnp.int32)))
    t = [torch.from_numpy(np.array(x)) for x in (q, p, g, lp, eps, mdc, var)]
    launches = trajectory.launches
    got = trajectory(*t, SEED, spec=tm.NealsFunnel(N, device="cpu").trajectory_spec(),
                     max_treedepth=D, Emax=1000.0, chain_block=CB)
    assert trajectory.launches == launches  # the CPU runs the plain version
    got = {k: v.numpy() for k, v in got.items()}
    agree = np.all([got[k] == want[k] for k in FLAGS], axis=0)
    _agreement(agree)
    held = np.repeat(agree.reshape(-1, CB).all(1), CB)
    assert held.mean() >= 0.5 and want["depth"].mean() > 2
    np.testing.assert_allclose(got["q"][held] / SD, want["q"][held] / SD, atol=1e-5, rtol=0)
    size = 1.0 + np.abs(want["energy"]) + np.abs(want["max_energy_change"])
    calm = held & ~want["diverging"]
    for k in ("energy", "logp"):
        assert (np.abs(got[k] - want[k]) <= 1e-4 * size)[calm].all(), k


def test_hmc_trajectory_plain_matches_jax_funnel():
    """(c) one HMC transition of 32 chains with step counts 1 to 40: the
    decisions as the module docstring says; on the chains that agree and
    did not diverge, q within 1e-4 of its marginal sd and the energies
    within 1e-4 of their and the energy change's size."""
    q, p, var, eps, lp, g = _diag_inputs(3, C, 0.15)
    n_steps = np.random.default_rng(4).integers(1, 41, C).astype(np.int32)
    op = build_hmc_trajectory_op(_jax_spec(), N, 1000.0,
                                 interpret=True, chain_block=CB)
    want = jax.tree.map(np.asarray, op(q, p, g, lp, eps, n_steps, var,
                                       jnp.asarray(SEED, jnp.int32)))
    t = [torch.from_numpy(np.array(x)) for x in (q, p, g, lp, eps, n_steps, var)]
    got = hmc_trajectory(*t, SEED, spec=tm.NealsFunnel(N, device="cpu").trajectory_spec(),
                         Emax=1000.0, chain_block=CB)
    got = {k: v.numpy() for k, v in got.items()}
    agree = (got["accepted"] == want["accepted"]) & (got["diverging"] == want["diverging"])
    _agreement(agree)
    assert 0 < want["accepted"].sum() < C
    calm = agree & ~want["diverging"]
    np.testing.assert_allclose(got["q"][calm] / SD, want["q"][calm] / SD, atol=1e-4, rtol=0)
    size = 1.0 + np.abs(want["energy"]) + np.abs(want["energy_change"])
    for k in ("logp", "energy", "energy_change"):
        assert (np.abs(got[k] - want[k]) <= 1e-4 * size)[calm].all(), k


# --------------------------------------------------------------------------
# (d) the fused ops' diag branch
# --------------------------------------------------------------------------

def _fused_inputs(seed, step):
    rng = np.random.default_rng(seed)
    q = _positions(seed, C)
    lp, g = (np.asarray(x) for x in jax.vmap(jm.NealsFunnel(N).logp_grad)(jnp.asarray(q)))
    f = np.float32
    ls = (np.log(step) + rng.uniform(-0.1, 0.1, C)).astype(f)
    sd = np.array([3.0] + [1.0] * (N - 1))
    x = dict(q=q, grad=g, logp=lp, iter_count=np.full(C, 250.0, f), da_log_step=ls,
             da_log_bar=ls.copy(), da_hbar=np.zeros(C, f), da_count=np.full(C, 40.0, f),
             da_mu=(ls + np.log(10.0)).astype(f),
             var=(sd ** 2 * rng.uniform(0.5, 2.0, (C, N))).astype(f))
    w = dict(fg_mean=(sd * rng.standard_normal((C, N)) * 0.3).astype(f),
             fg_raw=(40.0 * sd ** 2 * rng.uniform(0.5, 2.0, (C, N))).astype(f),
             fg_w=np.full(C, 40.0, f), fg_w2=np.full(C, 40.0, f),
             bg_mean=(sd * rng.standard_normal((C, N)) * 0.3).astype(f),
             bg_raw=(8.0 * sd ** 2 * rng.uniform(0.5, 2.0, (C, N))).astype(f),
             bg_w=np.full(C, 8.0, f), bg_w2=np.full(C, 8.0, f),
             n_samples=np.full(C, 48.0, f), window=np.full(C, 50.0, f))
    return x, tuple(w[k] for k in WELFORD_KEYS)


@pytest.mark.parametrize("sampler", ["nuts", "hmc"])
@pytest.mark.parametrize("T,tuning", [(3, False), (4, True)], ids=["draw_chunk", "tune_chunk"])
def test_fused_diag_plain_matches_jax_op(sampler, T, tuning):
    """(d) the fused op's diag branch against the JAX op, chain-draw for
    chain-draw, the step size held (a tune chunk with the per-chain
    Welford steps across a window swap): flags as the module docstring
    says; on the chain-draws held number for number (their block, NUTS, or
    chain, HMC, agreed so far) whose chain has not diverged, the trace within 1e-4 of the marginal sd and the energies
    within 1e-4 of their and the energy change's size; at the end, on the
    chains held throughout, the metric and Welford rows within 1e-4
    relative and the counters exactly."""
    x, welford = _fused_inputs(T + 11, 0.1 if sampler == "hmc" else 0.15)
    welford = welford if tuning else None
    keys = ("q", "grad", "logp", "iter_count") + DA_KEYS
    if sampler == "nuts":
        jcfg, cfg, build, op = (JNUTSConfig(adapt_step_size=False),
                                NUTSConfig(adapt_step_size=False), build_fused_nuts_op,
                                fused_nuts)
    else:
        jcfg, cfg, build, op = (JHMCConfig(adapt_step_size=False),
                                HMCConfig(adapt_step_size=False), build_fused_hmc_op,
                                fused_hmc)
    jop = build(_jax_spec(), N, T, tuning, tuning, jcfg,
                window_multiplier=2.0, chain_block=CB, interpret=True, pack=1, metric="diag")
    want = jop(*(jnp.asarray(x[k]) for k in keys), jnp.asarray(x["var"]),
               None if welford is None else tuple(map(jnp.asarray, welford)),
               jnp.asarray(SEED, jnp.int32))
    want = {k: np.asarray(v) for k, v in want.items() if v is not None}
    t = {k: torch.from_numpy(np.array(v)) for k, v in x.items()}
    got = op(*(t[k] for k in keys), t["var"], None, SEED,
             spec=tm.NealsFunnel(N, device="cpu").trajectory_spec(), T=T, tuning=tuning,
             config=cfg, metric="diag", window_multiplier=2.0, chain_block=CB,
             welford=None if welford is None else tuple(map(torch.from_numpy, welford)))
    got = {k: v.numpy() for k, v in got.items() if v is not None}
    flags = FLAGS if sampler == "nuts" else HMC_FLAGS
    agree = np.all([got[k] == want[k] for k in flags], axis=0)  # (T, C)
    _agreement(agree)
    # held: the chain's block (NUTS) or the chain (HMC) agreed at this
    # draw and at every earlier one; calm: held, and the chain diverged at
    # none of them (a divergent tree's proposal comes from a trajectory the
    # step size made unstable, whose rounding grows from step to step, and
    # the chain's next draw starts there)
    unit = CB if sampler == "nuts" else 1
    block = agree.reshape(T, -1, unit).all(-1)
    held = np.repeat(np.cumprod(block, axis=0).astype(bool), unit, axis=1)
    assert held.mean() >= 0.5
    calm = held & (np.cumsum(want["diverging"], axis=0) == 0)
    assert calm.mean() >= 0.25
    np.testing.assert_allclose(got["trace"][calm] / SD, want["trace"][calm] / SD, atol=1e-4,
                               rtol=0)
    e_tol = 1e-4 * (1.0 + np.abs(want["energy"]) + np.abs(want["energy_error"]))
    for k in ("energy", "model_logp", "energy_error"):
        assert (np.abs(got[k] - want[k]) <= e_tol)[calm].all(), k
    end = calm[-1]
    for k in DA_KEYS + ("iter_count", "logp"):
        np.testing.assert_allclose(got[k][end], want[k][end], rtol=1e-5, atol=1e-4)
    if tuning:
        for k in ("var",) + WELFORD_KEYS:
            g_, w_ = got[k][end], want[k][end]
            if g_.ndim == 2:
                np.testing.assert_allclose(g_, w_, rtol=1e-4, atol=1e-4 * np.abs(w_).max())
            else:
                np.testing.assert_array_equal(g_, w_)


# --------------------------------------------------------------------------
# (e) the election, (f) sample()
# --------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["centred", "non_centred"])
def test_engine_election_matches_jax(form):
    """(e) at 1024 chains both forms pack lanes in the JAX package (n = 10:
    pack 8), so ``fuse_draws=None`` elects ``fused_diag`` there, and the
    port's rule gives the same; with ``fuse_draws=False`` (run here at 16
    chains, 2 + 2 draws) the per-draw engine, ``per_draw_diag``."""
    jmodel = jm.NealsFunnel(N) if form == "centred" else jm.NonCenteredFunnel(N)
    tmodel = (tm.NealsFunnel(N, device="cpu") if form == "centred"
              else tm.NonCenteredFunnel(N, device="cpu"))
    pack = resolve_pack(jmodel.pallas_trajectory_spec(), N, 1024)
    assert pack > 1 and elect_fused_engine("diag", False, pack)
    assert _resolve_pack(tmodel.trajectory_spec(), N, 1024) == pack
    report = {}
    trace, _ = lt.sample(tmodel.logp_grad, model_ndim=N, chains=16, tune=2, draws=2,
                         random_seed=3, device="cpu", fuse_draws=False, perf_report=report,
                         progressbar=False, compute_convergence_checks=False)
    assert report["engine"] == "per_draw_diag" and report["trajectory"] == "plain"
    report = {}
    lt.sample(tmodel.logp_grad, model_ndim=N, chains=16, tune=2, draws=2, random_seed=3,
              device="cpu", perf_report=report, progressbar=False,
              compute_convergence_checks=False)
    assert report["engine"] == "fused_diag"
    assert trace.shape == (16, 2, N) and np.isfinite(trace).all()


@pytest.fixture(scope="module", params=["centred", "non_centred"])
def funnel_runs(request):
    """Both packages on each form, 150 tune + 150 draws: the port on its
    fused diag engine (the plain fused op here), 16 chains, the JAX
    package on its default engine on the CPU (the XLA tree), 32 chains;
    the centred form at target_accept 0.9, as the bench suite's cell."""
    form = request.param
    jmodel = jm.NealsFunnel(N) if form == "centred" else jm.NonCenteredFunnel(N)
    tmodel = (tm.NealsFunnel(N, device="cpu") if form == "centred"
              else tm.NonCenteredFunnel(N, device="cpu"))
    ta = 0.9 if form == "centred" else 0.8
    kw = dict(model_ndim=N, tune=150, draws=150, random_seed=4, progressbar=False)
    jrun = lmc.sample(logp_dlogp_func=jmodel.logp_grad, chains=C,
                      step=lmc.NUTS(model_ndim=N, target_accept=ta), **kw)
    treport = {}
    trun = lt.sample(tmodel.logp_grad, step=lt.NUTS(model_ndim=N, target_accept=ta), chains=16,
                     device="cpu", perf_report=treport, **kw)
    assert treport["engine"] == "fused_diag"
    return form, tmodel, jrun, trun


def test_funnel_sample_matches_jax(funnel_runs):
    """(f) the non-centred form: each dimension's mean within 5 Monte Carlo
    standard errors of 0 in both packages and the variances within 25% of
    1, no divergences; the funnel-space v sd through ``transform`` within
    25% of 3. The centred form: v's mean within 1.5 of each other (short
    runs explore the neck unevenly), v's sd within 30% of each other,
    divergence rates under 10% in both."""
    from littlemcmc_torch.utils.diagnostics import ess_bulk

    form, tmodel, (jtr, jst), (ttr, tst) = funnel_runs
    jtr = np.asarray(jtr)
    if form == "non_centred":
        for tr in (jtr, ttr):
            for i in range(N):
                se = 1.0 / np.sqrt(ess_bulk(tr[:, :, i]))
                assert abs(tr[:, :, i].mean()) < 5 * se, (i, tr[:, :, i].mean(), se)
            assert np.all(np.abs(tr.reshape(-1, N).var(0) - 1.0) < 0.25)
        assert tst["diverging"].sum() == 0
        v = tmodel.transform(ttr)[..., 0]
        assert abs(v.std() / 3.0 - 1.0) < 0.25
    else:
        jv, tv = jtr[..., 0], ttr[..., 0]
        assert abs(jv.mean() - tv.mean()) < 1.5, (jv.mean(), tv.mean())
        assert abs(tv.std() / jv.std() - 1.0) < 0.3, (tv.std(), jv.std())
        assert np.asarray(jst["diverging"]).mean() < 0.1 and tst["diverging"].mean() < 0.1
