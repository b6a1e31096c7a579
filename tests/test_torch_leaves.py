"""The port's leaf modules held against the JAX package.

``littlemcmc_torch`` math, report, integration, step sizes and the diagonal
quadpotential get the same inputs (made with numpy from a seed) as their
``littlemcmc_tpu`` counterparts and must give the same outputs. Both sides
compute in float32 with the same elementwise operations in the same order,
so the tolerance is float32's: 1e-6 relative (plus 1e-6 absolute near 0,
where a relative bound means nothing). Both packages run on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import littlemcmc_tpu.integration as j_int
import littlemcmc_tpu.math as j_math
import littlemcmc_tpu.quadpotential as j_qp
import littlemcmc_tpu.report as j_report
import littlemcmc_tpu.step_sizes as j_ss
import littlemcmc_tpu.utils.diagnostics as j_diag
import littlemcmc_torch.integration as t_int
import littlemcmc_torch.math as t_math
import littlemcmc_torch.quadpotential as t_qp
import littlemcmc_torch.report as t_report
import littlemcmc_torch.step_sizes as t_ss
import littlemcmc_torch.utils.diagnostics as t_diag

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def test_math_log_space_functions_match():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(1e-6, 0.683, 50), rng.uniform(0.683, 30.0, 50),
                        [0.683, 1e-3, 50.0]]).astype(np.float32)
    _close(t_math.log1mexp(torch.from_numpy(x)), j_math.log1mexp(jnp.asarray(x)))
    a = rng.uniform(-5, 5, 40).astype(np.float32)
    b = (a - rng.uniform(0.01, 4, 40)).astype(np.float32)
    _close(t_math.logdiffexp(torch.from_numpy(a), torch.from_numpy(b)),
           j_math.logdiffexp(jnp.asarray(a), jnp.asarray(b)))
    for x, m in ((0, 8), (1, 8), (104, 128), (128, 128), (129, 128)):
        assert t_math.round_up(x, m) == j_math.round_up(x, m)


def test_logbern_certain_and_nan_outcomes_match():
    log_p = np.array([0.0, -np.inf, np.nan, 0.0], np.float32)
    want = np.asarray(j_math.logbern(jax.random.key(0), jnp.asarray(log_p)))
    gen = torch.Generator().manual_seed(0)
    got = t_math.logbern(torch.from_numpy(log_p), gen).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [True, False, False, True])


def _stats(seed, chains=4, draws=200, n_div=0, accept=0.8, depth_hit=0.0,
           stuck=False):
    rng = np.random.default_rng(seed)
    div = np.zeros((chains, draws), bool)
    div.flat[rng.choice(div.size, n_div, replace=False)] = True
    energy = rng.standard_normal((chains, draws))
    if stuck:  # a random walk in energy: BFMI far below 0.2
        energy = np.cumsum(energy, axis=1)
    trace = rng.standard_normal((chains, draws, 3))
    if stuck:
        trace += np.arange(chains)[:, None, None]
    return {
        "diverging": div,
        "mean_tree_accept": np.clip(rng.normal(accept, 0.05, (chains, draws)), 0, 1),
        "reached_max_treedepth": rng.uniform(size=(chains, draws)) < depth_hit,
        "energy": energy,
    }, trace


@pytest.mark.parametrize("case", [
    dict(),
    dict(n_div=1),
    dict(n_div=7, accept=0.5),
    dict(depth_hit=0.3),
    dict(stuck=True),
])
def test_warnings_from_stats_match(case):
    stats, trace = _stats(1, **case)
    kw = dict(target_accept=0.8, max_treedepth=10, tune=20, trace=trace)
    want = j_report.warnings_from_stats(stats, **kw)
    got = t_report.warnings_from_stats(stats, **kw)
    assert [(w.kind.name, w.message, w.level) for w in got] == \
           [(w.kind.name, w.message, w.level) for w in want]
    for g, w in zip(got, want):
        if isinstance(w.extra, dict):
            assert g.extra.keys() == w.extra.keys()
            for k in w.extra:
                np.testing.assert_array_equal(np.asarray(g.extra[k]),
                                              np.asarray(w.extra[k]))


def test_beta_interval_matches():
    for good, bad in ((80.0, 20.0), (3.5, 96.5), (50.0, 50.0)):
        assert t_report._beta_interval_95(good, bad) == \
               j_report._beta_interval_95(good, bad)


def _diag_gauss(n, seed):
    """Elementwise Gaussian with precisions from the seed: same arithmetic
    in both packages, so the integrators can be held to float32."""
    prec = np.random.default_rng(seed).uniform(0.2, 5.0, n).astype(np.float32)
    pj, pt = jnp.asarray(prec), torch.from_numpy(prec)

    def jfn(q):
        g = -pj * q
        return 0.5 * jnp.sum(q * g), g

    def tfn(q):
        g = -pt * q
        return 0.5 * (q * g).sum(-1), g

    return jfn, tfn


@pytest.mark.parametrize("scheme", ["leapfrog", "two_stage", "three_stage"])
def test_leapfrog_matches(scheme):
    C, n = 6, 5
    rng = np.random.default_rng(2)
    q, p = (rng.standard_normal((C, n)).astype(np.float32) for _ in range(2))
    var = rng.uniform(0.5, 2.0, (C, n)).astype(np.float32)
    eps = rng.uniform(0.05, 0.4, C).astype(np.float32)
    jfn, tfn = _diag_gauss(n, 3)

    def j_step(q, p, v, e):
        pot = j_qp.QuadPotentialDiag.create(v)
        s = j_int.compute_state(pot, jfn, q, p)
        for _ in range(3):
            s = j_int.leapfrog(pot, jfn, e, s, scheme)
        return s

    want = jax.jit(jax.vmap(j_step))(q, p, var, eps)
    pot = t_qp.QuadPotentialDiag.create(torch.from_numpy(var))
    s = t_int.compute_state(pot, tfn, torch.from_numpy(q), torch.from_numpy(p))
    for _ in range(3):
        s = t_int.leapfrog(pot, tfn, torch.from_numpy(eps), s, scheme)
    for name in t_int.IntegratorState._fields:
        _close(getattr(s, name), getattr(want, name))
    # a trajectory start from the cached (logp, grad) equals a fresh evaluation
    again = t_int.recompute_with_momentum(pot, s.q, s.q_grad, s.model_logp, s.p)
    for name in t_int.IntegratorState._fields:
        _close(getattr(again, name), getattr(s, name), rtol=0, atol=0)


def test_dual_average_sequence_matches():
    C, steps = 5, 60
    rng = np.random.default_rng(4)
    accept = rng.uniform(0, 1, (steps, C)).astype(np.float32)
    adapting = rng.uniform(size=steps) < 0.8
    kw = dict(target=0.8, gamma=0.05, k=0.75, t0=10.0)
    js = jax.vmap(lambda _: j_ss.dual_average_init(0.3))(jnp.arange(C))
    ts = t_ss.dual_average_init(0.3, C)
    upd = jax.jit(jax.vmap(lambda s, a, ad: j_ss.dual_average_update(s, a, ad, **kw),
                           in_axes=(0, 0, None)))
    for a, ad in zip(accept, adapting):
        js = upd(js, a, bool(ad))
        ts = t_ss.dual_average_update(ts, torch.from_numpy(a), bool(ad), **kw)
        _close(ts.current(bool(ad)), js.current(bool(ad)))
    for f in ("log_step", "log_bar", "hbar", "count", "mu"):
        _close(getattr(ts, f), getattr(js, f))


@pytest.mark.parametrize("multiplier", [1.0, 1.5])
def test_diag_adapt_update_across_window_swap(multiplier):
    """Welford windows, metric refresh and the swap at n_samples % 101 == 0."""
    C, n, steps = 3, 4, 120
    rng = np.random.default_rng(5)
    mean0 = rng.standard_normal((C, n)).astype(np.float32)
    xs = (rng.standard_normal((steps, C, n)) * [0.5, 1.0, 2.0, 4.0]).astype(np.float32)
    tuning = np.ones(steps, bool)
    tuning[[10, 57]] = False

    js = jax.vmap(lambda m: j_qp.QuadPotentialDiagAdapt.create(
        n, initial_mean=m, initial_diag=jnp.ones(n), initial_weight=10.0,
        adaptation_window_multiplier=multiplier))(jnp.asarray(mean0))
    upd = jax.jit(jax.vmap(lambda pot, x, t: pot.update(x, x, t), in_axes=(0, 0, None)))
    ts = t_qp.QuadPotentialDiagAdapt.create(
        torch.from_numpy(mean0), torch.ones(C, n), 10.0,
        adaptation_window_multiplier=multiplier)
    for x, tu in zip(xs, tuning):
        js = upd(js, x, bool(tu))
        ts = ts.update(torch.from_numpy(x), None, bool(tu))
    assert int(ts.n_samples[0]) == steps - 2
    for f in ("var", "stds", "inv_stds", "n_samples", "window"):
        _close(getattr(ts, f), getattr(js, f))
    for side in ("fg", "bg"):
        for f in ("w_sum", "w_sum2", "mean", "raw_var"):
            _close(getattr(getattr(ts, side), f), getattr(getattr(js, side), f))
    z = rng.standard_normal((C, n)).astype(np.float32)
    p = torch.from_numpy(z) * ts.inv_stds
    _close(ts.kinetic(p), jax.vmap(lambda pot, q: pot.kinetic(q))(js, jnp.asarray(p.numpy())))


def test_diagnostics_match():
    """split R-hat, bulk ESS, BFMI and the summary table: host-side float64
    numpy in both packages, so they must agree to rounding."""
    rng = np.random.default_rng(6)
    ar = np.zeros((4, 301, 3))
    for t in range(1, 301):  # AR(1) chains: ESS well below the draw count
        ar[:, t] = 0.7 * ar[:, t - 1] + rng.standard_normal((4, 3))
    ar[1] += 0.3
    for i in range(3):
        for f in ("split_rhat", "ess_bulk"):
            for rank in (True, False):
                np.testing.assert_allclose(getattr(t_diag, f)(ar[:, :, i], rank),
                                           getattr(j_diag, f)(ar[:, :, i], rank), rtol=1e-12)
    np.testing.assert_allclose(t_diag.bfmi(ar[:, :, 0]), j_diag.bfmi(ar[:, :, 0]), rtol=1e-12)
    stats = {"diverging": rng.uniform(size=(4, 301)) < 0.01}
    got, want = t_diag.summary(ar, stats), j_diag.summary(ar, stats)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12)


@pytest.mark.parametrize("bad", [0.0, np.inf])
def test_raise_ok_messages_match(bad):
    diag = np.array([1.0, bad, 2.0, bad], np.float32)
    j_pot = j_qp.QuadPotentialDiagAdapt.create(4, initial_diag=jnp.asarray(diag))
    t_pot = t_qp.QuadPotentialDiagAdapt.create(torch.zeros(4), torch.from_numpy(diag))
    with pytest.raises(ValueError) as want:
        j_pot.raise_ok()
    with pytest.raises(ValueError) as got:
        t_pot.raise_ok()
    assert str(got.value) == str(want.value)
    t_qp.QuadPotentialDiagAdapt.create(torch.zeros(3)).broadcast(5).raise_ok()
