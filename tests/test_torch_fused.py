"""The port's dense metric paths held against the JAX package on the CPU.

- (i) the trajectory op's dense branch against ``build_trajectory_op(
  metric="dense", interpret=True)``;
- (ii) the fused op's plain version against ``build_fused_nuts_op(
  metric="dense", interpret=True)``: a static draw chunk and an
  ``adapt_dense`` tune chunk that crosses a window swap;
- (iii) ``sample(init="jitter+adapt_full")`` of both packages on the model
  of ``tests/test_fused_nuts.py:355-404``;
- (iv) the engine election of ``sample()`` and its chunk loop.

Both packages draw the same counter streams, so (i) and (ii) compare tree
for tree. The JAX side's model body here is a test-local spec in full
float32; its dense velocity (``make_velocities``) stays the package's
bf16x3 split, about 2^-21 relative, so a rounding difference can flip a
decision now and then: at least 15 of 16 chains must agree per draw.

Dual averaging amplifies rounding: each draw's accept statistic sets the
next draw's step size, so a rounding difference in one draw moves every
later tree. So a tune chunk is
held tree for tree with step-size adaptation off, and with it on its
first draw is held tree for tree and the dual-averaging and Welford
states are held to replays of the chunk's own outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import littlemcmc_tpu as lmc
import littlemcmc_torch as lt
from littlemcmc_tpu import models as jm
from littlemcmc_tpu.base import NUTSConfig as JConfig
from littlemcmc_tpu.ops import PallasModelSpec, build_trajectory_op
from littlemcmc_tpu.ops.fused_nuts_pallas import build_fused_nuts_op
from littlemcmc_tpu.ops.fused_nuts_pallas import combine_dense_welford as j_combine
from littlemcmc_tpu.ops.nuts_trajectory_pallas import _fmix32, padded_dim
from littlemcmc_tpu.step_sizes import DualAverageState as JDualAverage
from littlemcmc_tpu.step_sizes import dual_average_update
from littlemcmc_torch import models as tm
from littlemcmc_torch.base import NUTSConfig
from littlemcmc_torch.ops import trajectory
from littlemcmc_torch.ops.fused_nuts import combine_dense_welford, dense_momentum, fused_nuts

torch.set_num_threads(1)

N, C, CB = 6, 16, 8
FLAGS = ("depth", "n_leaves", "diverging", "turning")
SEED = (1234567, -89)
DA_KEYS = ("da_log_step", "da_log_bar", "da_hbar", "da_count", "da_mu")


@pytest.fixture(scope="module")
def models():
    """The JAX model, its body in full float32, and the port's model."""
    jmodel = jm.CorrelatedGaussian(N, rho=0.6)
    npad = padded_dim(N)
    prec = np.zeros((npad, npad), np.float32)
    prec[:N, :N] = jmodel.prec.astype(np.float32)

    def fn(q, p):
        g = -jnp.dot(q, p, precision="highest", preferred_element_type=jnp.float32)
        return 0.5 * jnp.sum(q * g, axis=1, keepdims=True), g

    tmodel = tm.CorrelatedGaussian(N, rho=0.6, device="cpu")
    return jmodel, PallasModelSpec(fn, (jnp.asarray(prec),), N), tmodel


def _metric(model):
    cov = model.cov.astype(np.float32)
    chol = np.linalg.cholesky(cov.astype(np.float64))
    linv = np.linalg.inv(chol).astype(np.float32)
    return cov, linv, chol


def _sd(model):
    return np.sqrt(model.true_var)


def test_dense_trajectory_plain_matches_jax(models):
    """(i) one transition, block for block, from stationary inputs with the
    true covariance as the metric."""
    jmodel, jspec, tmodel = models
    cov, _, chol = _metric(jmodel)
    rng = np.random.default_rng(3)
    q = (rng.standard_normal((C, N)) @ chol.T).astype(np.float32)
    p = np.ascontiguousarray(np.linalg.solve(chol.T, rng.standard_normal((N, C))).T,
                             dtype=np.float32)
    eps = (0.7 * rng.uniform(0.8, 1.2, C)).astype(np.float32)
    D = 8
    mdc = np.full(C, D, np.int32)
    mdc[::5] = D - 2
    lp, g = (np.asarray(x) for x in jax.vmap(jmodel.logp_grad)(jnp.asarray(q)))
    op = build_trajectory_op(jspec, N, D, 1000.0, "leapfrog", interpret=True,
                             chain_block=CB, metric="dense")
    want = jax.tree.map(np.asarray, op(q, p, g, lp, eps, mdc, cov,
                                       jnp.asarray(SEED, jnp.int32)))
    t = [torch.tensor(x) for x in (q, p, g, lp, eps, mdc, cov)]
    launches = trajectory.launches
    got = trajectory(*t, SEED, spec=tmodel.trajectory_spec(), max_treedepth=D, Emax=1000.0,
                     chain_block=CB, metric="dense")
    assert trajectory.launches == launches  # the CPU runs the plain version
    got = {k: v.numpy() for k, v in got.items()}
    agree = np.all([got[k] == want[k] for k in FLAGS], axis=0)
    assert agree.sum() >= C - 1, agree
    assert want["depth"].mean() > 1.5
    np.testing.assert_allclose(got["q"][agree] / _sd(jmodel), want["q"][agree] / _sd(jmodel),
                               atol=1e-4, rtol=0)
    # energies within 1e-4 relative: the JAX velocity's bf16x3 split rounds
    # at about 2^-21 per product, carried through every leapfrog step
    for k in ("energy", "logp", "log_size"):
        np.testing.assert_allclose(got[k][agree], want[k][agree], atol=1e-4, rtol=1e-4)


def test_dense_momentum_matches_the_jax_stream():
    """The momentum draw: the stream of ``_make_counter_uniform``'s row
    salts (nuts_trajectory_pallas.py:354-369) for calls 1 and 2, Box-Muller
    (fused_nuts_pallas.py:134-140) and ``z @ L^-1``, written out in jnp."""
    model = jm.CorrelatedGaussian(N, rho=0.6)
    _, linv, _ = _metric(model)
    s0, s1, blk, rows = 2 ** 31 - 11, -5, 1, CB
    npad = padded_dim(N)
    base = jnp.uint32((s0 + blk * 7919 + 1013904223) % 2 ** 32)
    lane = (jnp.arange(rows, dtype=jnp.uint32)[:, None] * jnp.uint32(npad)
            + jnp.arange(N, dtype=jnp.uint32)[None, :])
    s1u = jnp.asarray(s1, jnp.int32).astype(jnp.uint32) * jnp.uint32(0x9E3779B9)
    salt = _fmix32((base + lane * jnp.uint32(65063) + jnp.uint32(17)) ^ s1u)

    def u(c):
        x = _fmix32(salt ^ (jnp.uint32(c) * jnp.uint32(0x9E3779B9)))
        return ((x >> jnp.uint32(8)).astype(jnp.int32).astype(jnp.float32) + 0.5) / (1 << 24)

    z = jnp.sqrt(-2.0 * jnp.log(u(1))) * jnp.cos(6.283185307179586 * u(2))
    want = np.asarray(jnp.dot(z, jnp.asarray(linv), precision="highest"))
    got = dense_momentum(s0, s1, blk, rows, torch.from_numpy(linv)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def _fused_inputs(model, seed):
    cov, linv, chol = _metric(model)
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((C, N)) @ chol.T).astype(np.float32)
    lp, g = (np.asarray(x) for x in jax.vmap(model.logp_grad)(jnp.asarray(q)))
    ls = (np.log(0.8) + rng.uniform(-0.1, 0.1, C)).astype(np.float32)
    f = np.float32
    return dict(q=q, grad=g, logp=lp, iter_count=np.full(C, 250.0, f), da_log_step=ls,
                da_log_bar=ls.copy(), da_hbar=np.zeros(C, f), da_count=np.full(C, 40.0, f),
                da_mu=(ls + np.log(10.0)).astype(f), cov=cov, linv=linv)


def _welford_seed(model, seed):
    """A global pooled state whose windows swap at draw 2 (n_samples 3,
    prev_update 0, window 5)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, 2 * N)).astype(np.float32)
    Bm = rng.standard_normal((N, 2 * N)).astype(np.float32)
    f = np.float32
    return ((0.1 * rng.standard_normal(N)).astype(f), (A @ A.T).astype(f), f(12.0),
            (0.05 * rng.standard_normal(N)).astype(f), (0.25 * (Bm @ Bm.T)).astype(f),
            f(6.0), f(3.0), f(0.0), f(5.0))


def _run_both(models, T, tuning, adapt_step_size, seed):
    jmodel, jspec, tmodel = models
    x = _fused_inputs(jmodel, seed)
    welford = _welford_seed(jmodel, seed) if tuning else None
    jcfg = JConfig(adapt_step_size=adapt_step_size)
    op = build_fused_nuts_op(jspec, N, T, tuning, False, jcfg, window_multiplier=2.0,
                             interpret=True, chain_block=CB, metric="dense",
                             adapt_dense=tuning)
    want = op(*(jnp.asarray(x[k]) for k in ("q", "grad", "logp", "iter_count") + DA_KEYS),
              jnp.asarray(x["cov"]), None, jnp.asarray(SEED, jnp.int32),
              linv=jnp.asarray(x["linv"]),
              dense_welford=None if welford is None else tuple(map(jnp.asarray, welford)))
    want = {k: np.asarray(v) for k, v in want.items() if v is not None}
    t = {k: torch.tensor(v) for k, v in x.items()}
    launches = fused_nuts.launches
    got = fused_nuts(*(t[k] for k in ("q", "grad", "logp", "iter_count") + DA_KEYS),
                     t["cov"], t["linv"], SEED, spec=tmodel.trajectory_spec(), T=T,
                     tuning=tuning, config=NUTSConfig(adapt_step_size=adapt_step_size),
                     window_multiplier=2.0, chain_block=CB,
                     dense_welford=None if welford is None
                     else tuple(torch.tensor(w) for w in welford))
    assert fused_nuts.launches == launches  # the CPU runs the plain version
    got = {k: v.numpy() for k, v in got.items() if v is not None}
    return jmodel, x, welford, got, want


def _agreement(got, want):
    """Per (draw, chain): every chain of the chain's block agreed on every
    flag at this draw and all earlier ones (a disagreement changes the
    block's shared counter stream from then on)."""
    agree = np.all([got[k] == want[k] for k in FLAGS], axis=0)  # (T, C)
    block = agree.reshape(agree.shape[0], -1, CB).all(-1)
    return agree, np.repeat(np.cumprod(block, axis=0).astype(bool), CB, axis=1)


def _replay_welford(welford, trace, mult=2.0):
    """Sequential pooled Welford bookkeeping in float64 (every chain's
    position joins both windows each draw, then the shared swap)."""
    fgm, fgr, fgw, bgm, bgr, bgw, ns, pu, win = (np.asarray(w, np.float64) for w in welford)

    def add(m, r, w, x):
        w1 = w + 1.0
        d = x - m
        m1 = m + d / w1
        return m1, r + np.outer(d, x - m1), w1

    for t in range(trace.shape[0]):
        for c in range(trace.shape[1]):
            fgm, fgr, fgw = add(fgm, fgr, fgw, trace[t, c])
            bgm, bgr, bgw = add(bgm, bgr, bgw, trace[t, c])
        if ns - pu >= win:
            fgm, fgr, fgw = bgm, bgr, bgw
            bgm, bgr, bgw = np.zeros(N), np.zeros((N, N)), 0.0
            pu, win = ns, np.floor(win * mult)
        ns = ns + 1.0
    return (fgw, fgm, fgr), (bgw, bgm, bgr), (ns, pu, win)


def _combined(out, welford, combine, asarray):
    return [tuple(np.asarray(v, np.float64) for v in combine(
        *(asarray(out[f"dense_{side}_{k}"]) for k in ("w", "mean", "raw")),
        asarray(welford[0]))) for side in ("fg", "bg")]


def _assert_welford_close(a, b):
    for (wa, ma, ra), (wb, mb, rb) in zip(a, b):
        assert float(wa) == float(wb)
        np.testing.assert_allclose(ma, mb, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(ra, rb, rtol=1e-3, atol=1e-3)


def _assert_accept_close(got, want, held, e_tol):
    """``mean_tree_accept`` averages the leaves' exp(min(0, E0 - E)), each
    of which moves by at most the error of E0 - E: twice the energies'
    tolerance ``e_tol``, relative."""
    g, w = got["mean_tree_accept"][held], want["mean_tree_accept"][held]
    err = np.abs(g - w)
    assert (err <= 2 * e_tol * w + 1e-7).all(), err.max()
    assert w.mean() > 0.3  # trees long enough to hold the statistic


@pytest.mark.parametrize("T,tuning", [(4, False), (8, True)], ids=["draw_chunk", "tune_chunk"])
def test_fused_plain_matches_jax_op(models, T, tuning):
    """(ii) the fused op tree for tree: a static draw chunk, and an
    adapt_dense tune chunk crossing a window swap, with step-size
    adaptation off."""
    jmodel, x, welford, got, want = _run_both(models, T, tuning, False, seed=5)
    agree, same = _agreement(got, want)
    assert (agree.sum(1) >= C - 1).all(), agree
    assert same.mean() >= 0.5
    assert got["depth"].mean() > 1.5
    sd = _sd(jmodel)
    np.testing.assert_allclose(got["trace"][same] / sd, want["trace"][same] / sd,
                               atol=1e-4, rtol=0)
    for k in ("energy", "model_logp"):
        np.testing.assert_allclose(got[k][same], want[k][same], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got["logp"][same[-1]], want["logp"][same[-1]], atol=1e-4,
                               rtol=1e-4)
    # the energy error is a difference of two energies, so it carries their
    # absolute error: 1e-4 of the energy's size
    e_tol = 1e-4 * (1.0 + np.abs(want["energy"][same]))
    for k in ("energy_error", "max_energy_change"):
        err = np.abs(got[k] - want[k])[same]
        assert (err <= e_tol).all(), (k, err.max())
    _assert_accept_close(got, want, same, e_tol)
    for k in ("step_size", "step_size_bar"):
        np.testing.assert_allclose(got[k][same], want[k][same], rtol=1e-5)
    for k in DA_KEYS + ("iter_count",):
        np.testing.assert_allclose(got[k][same[-1]], want[k][same[-1]], rtol=1e-5, atol=1e-6)
    if tuning:
        assert got["n_samples"] == want["n_samples"] == 3.0 + T
        assert got["prev_update"] == want["prev_update"] == 5.0
        assert got["window"] == want["window"] == 10.0
        assert same.all()
        port = _combined(got, welford, combine_dense_welford, torch.from_numpy)
        jax_ = _combined(want, welford, j_combine, jnp.asarray)
        fg, bg, _ = _replay_welford(welford, got["trace"].astype(np.float64))
        _assert_welford_close(port, jax_)
        _assert_welford_close(port, [fg, bg])


def test_fused_plain_tune_chunk_with_dual_averaging(models):
    """(ii) the tune chunk as the main path runs it, step size adapting:
    its first draw tree for tree against the JAX op, the dual-averaging
    state against the JAX package's update replayed over the chunk's own
    accept statistics, and the pooled Welford state against a float64
    replay of the chunk's own trace."""
    jmodel, x, welford, got, want = _run_both(models, 8, True, True, seed=6)
    agree, same = _agreement(got, want)
    assert agree[0].sum() >= C - 1
    sd = _sd(jmodel)
    np.testing.assert_allclose(got["trace"][0][same[0]] / sd, want["trace"][0][same[0]] / sd,
                               atol=1e-4, rtol=0)
    # the first draw's stats against the JAX op's: the step sizes within
    # 1e-5 relative plus what dual averaging makes of the accept
    # statistic's difference, sqrt(count) / (gamma (count + t0)) per unit
    first = np.zeros_like(same)
    first[0] = same[0]
    _assert_accept_close(got, want, first, 1e-4 * (1.0 + np.abs(want["energy"][first])))
    cnt = x["da_count"]
    d_mta = np.abs(got["mean_tree_accept"][0] - want["mean_tree_accept"][0])
    lim = 1e-5 + np.sqrt(cnt) / (JConfig().gamma * (cnt + JConfig().t0)) * d_mta
    for k in ("step_size", "step_size_bar"):
        rel = np.abs(got[k][0] - want[k][0]) / want[k][0]
        assert (rel[same[0]] <= lim[same[0]]).all(), (k, rel.max())
    cfg = JConfig()
    da = JDualAverage(*(jnp.asarray(x[k]) for k in DA_KEYS[:3]),
                      count=jnp.asarray(x["da_count"]).astype(jnp.int32),
                      mu=jnp.asarray(x["da_mu"]))
    for t in range(8):
        da = dual_average_update(da, jnp.asarray(got["mean_tree_accept"][t]), True,
                                 target=cfg.target_accept, gamma=cfg.gamma, k=cfg.k,
                                 t0=cfg.t0)
    for k, want_k in zip(DA_KEYS, (da.log_step, da.log_bar, da.hbar, da.count, da.mu)):
        np.testing.assert_allclose(got[k], np.asarray(want_k, np.float32), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(got["step_size"][-1], np.exp(got["da_log_step"]), rtol=1e-6)
    fg, bg, counters = _replay_welford(welford, got["trace"].astype(np.float64))
    _assert_welford_close(_combined(got, welford, combine_dense_welford, torch.from_numpy),
                          [fg, bg])
    assert (got["n_samples"], got["prev_update"], got["window"]) == counters


@pytest.fixture(scope="module")
def slice_runs():
    """(iii) both packages on the model of tests/test_fused_nuts.py:355-404."""
    jmodel = jm.CorrelatedGaussian(5, rho=0.8, scale_range=(0.5, 2.0))
    kw = dict(model_ndim=5, chains=32, tune=300, draws=300, random_seed=9,
              init="jitter+adapt_full", cross_chain_adapt=True, progressbar=False,
              return_final_state=True)
    step = lmc.NUTS(model_ndim=5, pallas_trajectory=jmodel.pallas_trajectory_spec(),
                    pallas_interpret=True)
    jrun = lmc.sample(logp_dlogp_func=jmodel.logp_grad, step=step, fuse_draws=True, **kw)
    tmodel = tm.CorrelatedGaussian(5, rho=0.8, scale_range=(0.5, 2.0), device="cpu")
    report = {}
    trun = lt.sample(tmodel.logp_grad, device="cpu", perf_report=report, **kw)
    return jmodel, jrun, trun, report


def test_slice_matches_jax_sample(slice_runs):
    """(iii) the slice as a whole: posterior, adapted step size and the
    pooled-covariance bookkeeping."""
    model, (jtr, jst, jfs), (ttr, tst, tfs), report = slice_runs
    assert report["engine"] == "fused_dense_pooled"
    for tr in (np.asarray(jtr), ttr):
        np.testing.assert_allclose(tr.reshape(-1, 5).var(0), model.true_var, rtol=0.3)
    step_j = float(np.exp(np.asarray(jfs.da.log_bar)).mean())
    step_t = float(torch.exp(tfs.da.log_bar).mean())
    assert abs(np.log(step_t / step_j)) < np.log(1.35), (step_t, step_j)
    np.testing.assert_allclose(float(tfs.potential.fg.n_samples.sum()),
                               float(np.asarray(jfs.potential.fg.n_samples).sum()), rtol=1e-6)
    for k in ("n_samples", "prev_update", "window"):
        np.testing.assert_array_equal(getattr(tfs.potential, k).numpy(),
                                      np.asarray(getattr(jfs.potential, k)))
    for st in (np.asarray(jst["depth"]), tst["depth"]):
        assert float(st[:, -200:].mean()) <= 4.0
    assert tst["diverging"].mean() < 0.02


@pytest.mark.parametrize("chains,fuse_draws,engine", [
    (128, None, "fused_dense_pooled"),
    (128, False, "per_draw_dense_pooled"),
    (64, True, None),
    (64, None, "per_draw_dense"),
], ids=["fused", "per_draw", "per_chain_raises", "per_chain"])
def test_adapt_full_engine_election(chains, fuse_draws, engine):
    """(iv) adapt_full pools at >= 128 chains and runs the fused engine
    unless fuse_draws=False; per-chain dense adaptation (64 chains) runs on
    the per-draw engine's tensor-op tree, and the fused kernels refuse it
    (``fuse_draws=True`` raises)."""
    model = tm.CorrelatedGaussian(3, device="cpu")
    kw = dict(model_ndim=3, chains=chains, tune=12, draws=4, random_seed=2,
              init="adapt_full", fuse_draws=fuse_draws, device="cpu", chain_block=64,
              progressbar=False, compute_convergence_checks=False)
    if engine is None:
        with pytest.raises(ValueError, match="fuse_draws=True"):
            lt.sample(model.logp_grad, **kw)
        return
    report = {}
    trace, stats = lt.sample(model.logp_grad, perf_report=report, **kw)
    assert report["engine"] == engine
    assert report["trajectory"] == ("tensor" if engine == "per_draw_dense" else "plain")
    assert report["kernel_launches"] == {"nuts_trajectory": 0, "fused_nuts": 0}
    assert trace.shape == (chains, 4, 3) and np.isfinite(trace).all()


def test_chunk_loop_follows_the_pooled_tune_schedule():
    """(iv) the slice's call runs 12 chunks: tune 10, 10, 30, 50, 100 x 4,
    then draws 250 x 4; a factory without a schedule runs 250-draw tune
    chunks."""
    from littlemcmc_torch.base import pooled_tune_schedule
    from littlemcmc_torch.sampling import _run_chunked

    def recorder(schedule):
        calls = []

        def factory(chunk, tuning, collect):
            def run_chunk(state, iter0):
                calls.append((iter0, chunk, tuning, collect))
                return state, (chunk,), torch.tensor(1, dtype=torch.int32)
            return run_chunk

        if schedule:
            factory.tune_chunk_schedule = pooled_tune_schedule
        return factory, calls

    factory, calls = recorder(True)
    state, outs, ndiv = _run_chunked(factory, "state", 500, 1000, collect_tune=False)
    assert [c[1] for c in calls] == [10, 10, 30, 50, 100, 100, 100, 100, 250, 250, 250, 250]
    assert [c[0] for c in calls][:5] == [0, 10, 20, 50, 100]
    assert [c[2] for c in calls] == [True] * 8 + [False] * 4
    assert outs == [(250,)] * 4 and int(ndiv) == 12 and state == "state"
    factory, calls = recorder(False)
    _run_chunked(factory, "state", 500, 1000, collect_tune=True)
    assert [c[1] for c in calls] == [250, 250] + [250] * 4
    assert all(c[3] for c in calls)
