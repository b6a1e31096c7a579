"""The port's dense metric and pooled adaptation held against the JAX package.

``littlemcmc_torch`` ``WelfordCovariance``, ``QuadPotentialFull``,
``QuadPotentialFullAdapt``, the ``quad_potential`` factory, the cross-chain
pooling of ``parallel/cross_chain.py``, the fused engine's boundary pieces
(``_pool_dense_welford``, ``combine_dense_welford``,
``_dense_boundary_potential``), ``pooled_tune_schedule`` and ``convert``'s
dense leaves get the same inputs (made with numpy from a seed) as their
``littlemcmc_tpu`` counterparts. Both sides compute in float32; sums over
chains and Cholesky factors may round in another order, so the tolerance
is 1e-5 relative (1e-5 absolute near 0). The JAX functions run jitted
over a few shapes, to keep the XLA compiles of this process few.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import littlemcmc_tpu.quadpotential as j_qp
from littlemcmc_tpu.base import pooled_tune_schedule as j_schedule
from littlemcmc_tpu.nuts import _dense_boundary_potential as j_boundary
from littlemcmc_tpu.nuts import _pool_dense_welford as j_pool_welford
from littlemcmc_tpu.ops.fused_nuts_pallas import combine_dense_welford as j_combine
from littlemcmc_tpu.parallel import cross_chain as j_cc
import littlemcmc_torch.quadpotential as t_qp
from littlemcmc_torch.base import pooled_tune_schedule as t_schedule
from littlemcmc_torch.convert import chain_state_from_numpy, chain_state_to_numpy
from littlemcmc_torch.nuts import _dense_boundary_potential as t_boundary
from littlemcmc_torch.nuts import _pool_dense_welford as t_pool_welford
from littlemcmc_torch.ops.fused_nuts import combine_dense_welford as t_combine
from littlemcmc_torch.parallel import cross_chain as t_cc

torch.set_num_threads(1)

C, N = 4, 5
RTOL = ATOL = 1e-5
WELFORD_COV = ("n_samples", "mean", "raw_cov")
FULL_ADAPT = ("cov", "chol", "chol_failed", "n_samples", "prev_update", "window")


def _close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=err_msg)


def _assert_full_adapt_close(t, j):
    for f in FULL_ADAPT:
        _close(getattr(t, f), getattr(j, f), err_msg=f)
    for side in ("fg", "bg"):
        for f in WELFORD_COV:
            _close(getattr(getattr(t, side), f), getattr(getattr(j, side), f),
                   err_msg=f"{side}.{f}")


def _samples(steps, seed):
    """Correlated samples, one per chain and step: ``(steps, C, N)``."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, N)) * [0.5, 1.0, 2.0, 1.5, 0.8]
    return (rng.standard_normal((steps, C, N)) @ A.T + 0.3).astype(np.float32)


def test_welford_covariance_add_sample_matches():
    """30 samples into a Welford state with an initial weight."""
    xs = _samples(30, 1)
    mean0 = np.random.default_rng(2).standard_normal((C, N)).astype(np.float32)
    cov0 = (np.eye(N) * 2.0).astype(np.float32)
    jw = jax.vmap(lambda m: j_qp.WelfordCovariance.create(N, m, jnp.asarray(cov0), 3.0))(
        jnp.asarray(mean0))
    add = jax.jit(jax.vmap(lambda w, x: w.add_sample(x)))
    tw = t_qp.WelfordCovariance.create(torch.from_numpy(mean0), torch.from_numpy(cov0), 3.0)
    for x in xs:
        jw = add(jw, jnp.asarray(x))
        tw = tw.add_sample(torch.from_numpy(x))
    for f in WELFORD_COV:
        _close(getattr(tw, f), getattr(jw, f), err_msg=f)
    _close(tw.current_covariance(), jax.vmap(lambda w: w.current_covariance())(jw))


def _full_adapt_pair(steps, seed, window=7):
    """Chain-batched ``QuadPotentialFullAdapt`` of both packages after
    ``steps`` tuning updates (windows of ``window`` draws, doubling), with
    non-tuning draws in between that must change nothing."""
    xs = _samples(steps, seed)
    tuning = np.ones(steps, bool)
    tuning[[3, 11]] = False
    mean0 = xs[0]
    jp = jax.vmap(lambda m: j_qp.QuadPotentialFullAdapt.create(
        N, initial_mean=m, initial_cov=jnp.eye(N), initial_weight=10.0,
        adaptation_window=window))(jnp.asarray(mean0))
    upd = jax.jit(jax.vmap(lambda pot, x, t: pot.update(x, x, t), in_axes=(0, 0, None)))
    tp = t_qp.QuadPotentialFullAdapt.create(torch.from_numpy(mean0), torch.eye(N),
                                            initial_weight=10.0, adaptation_window=window)
    for x, tu in zip(xs, tuning):
        jp = upd(jp, jnp.asarray(x), bool(tu))
        tp = tp.update(torch.from_numpy(x), None, bool(tu))
    return tp, jp, int(tuning.sum())


def test_full_adapt_update_across_window_swaps():
    """Stan shrinkage, the Cholesky refresh every draw, and two window swaps
    (at 7 and at 21 tuned draws)."""
    tp, jp, n_tuned = _full_adapt_pair(30, 3)
    assert int(tp.n_samples[0]) == n_tuned and int(tp.window[0]) == 28
    assert int(tp.prev_update[0]) == 21
    _assert_full_adapt_close(tp, jp)
    # the adapted metric's velocity and kinetic energy
    p = torch.from_numpy(np.random.default_rng(4).standard_normal((C, N)).astype(np.float32))
    _close(tp.velocity(p), jax.vmap(lambda pot, x: pot.velocity(x))(jp, jnp.asarray(p.numpy())))
    _close(tp.kinetic(p), jax.vmap(lambda pot, x: pot.kinetic(x))(jp, jnp.asarray(p.numpy())))


def test_full_adapt_latches_a_failed_cholesky():
    """A non-positive-definite refresh keeps the old factor, takes the new
    covariance and latches ``chol_failed`` in both packages."""
    tp, jp, _ = _full_adapt_pair(12, 5)
    # a negative raw-scatter entry makes the foreground indefinite; the
    # sample is the foreground mean, so the add leaves the scatter as it is
    jp = jp.replace(fg=jp.fg.replace(raw_cov=jp.fg.raw_cov.at[:, 0, 0].set(-1e3)))
    tp = tp.replace(fg=t_qp.WelfordCovariance(
        tp.fg.n_samples, tp.fg.mean, tp.fg.raw_cov.clone().index_put_(
            (torch.arange(C), torch.tensor(0), torch.tensor(0)), torch.tensor(-1e3))))
    at_mean = np.array(jp.fg.mean)
    jp2 = jax.vmap(lambda pot, x: pot.update(x, x, True))(jp, jnp.asarray(at_mean))
    tp2 = tp.update(torch.from_numpy(at_mean), None, True)
    assert bool(tp2.chol_failed.all()) and bool(np.asarray(jp2.chol_failed).all())
    _close(tp2.chol, tp.chol)
    _assert_full_adapt_close(tp2, jp2)
    with pytest.raises(ValueError, match="Cholesky"):
        tp2.raise_ok()


def test_quad_potential_full_and_factory_match():
    rng = np.random.default_rng(6)
    A = rng.standard_normal((N, 2 * N))
    cov = (A @ A.T / (2 * N) + 0.5 * np.eye(N)).astype(np.float32)
    tq = t_qp.quad_potential(cov, is_cov=True)
    jq = j_qp.quad_potential(jnp.asarray(cov), is_cov=True)
    assert isinstance(tq, t_qp.QuadPotentialFull) and isinstance(jq, j_qp.QuadPotentialFull)
    _close(tq.chol, jq.chol)
    p = rng.standard_normal(N).astype(np.float32)
    _close(tq.velocity(torch.from_numpy(p)), jq.velocity(jnp.asarray(p)))
    _close(tq.kinetic(torch.from_numpy(p)), jq.kinetic(jnp.asarray(p)))
    # a broadcast metric: every chain's row is the same
    tb = tq.broadcast(C)
    pc = rng.standard_normal((C, N)).astype(np.float32)
    _close(tb.velocity(torch.from_numpy(pc)), pc @ cov.T)
    diag = np.array([1.0, 2.0, 0.5, 4.0, 3.0], np.float32)
    for is_cov in (True, False):
        _close(t_qp.quad_potential(diag, is_cov).v, j_qp.quad_potential(diag, is_cov).v)
    bad = cov.copy()
    bad[2, 2] = -1.0
    for qp in (t_qp, j_qp):
        with pytest.raises(qp.PositiveDefiniteError) as err:
            qp.quad_potential(bad, is_cov=True)
        assert list(err.value.idx) == [2]
        assert "Check indexes [2]" in str(err.value)


def test_cross_chain_pool_dense_and_diag_match():
    """The pooled covariance and the pooled metric of both branches."""
    tp, jp, _ = _full_adapt_pair(12, 7)
    _close(t_cc._pooled_cov(tp), j_cc._pooled_cov(jp))
    tpool = t_cc.cross_chain_potential_pool(tp, True)
    jpool = j_cc.cross_chain_potential_pool(jp, True)
    _assert_full_adapt_close(tpool, jpool)
    assert t_cc.cross_chain_potential_pool(tp, False) is tp

    xs = _samples(9, 8)
    jd = jax.vmap(lambda m: j_qp.QuadPotentialDiagAdapt.create(
        N, initial_mean=m, initial_diag=jnp.ones(N), initial_weight=10.0))(jnp.asarray(xs[0]))
    td = t_qp.QuadPotentialDiagAdapt.create(torch.from_numpy(xs[0]), torch.ones(C, N), 10.0)
    upd = jax.jit(jax.vmap(lambda pot, x: pot.update(x, x, True)))
    for x in xs:
        jd = upd(jd, jnp.asarray(x))
        td = td.update(torch.from_numpy(x), None, True)
    tdp = t_cc.cross_chain_potential_pool(td, True)
    jdp = j_cc.cross_chain_potential_pool(jd, True)
    for f in ("var", "stds", "inv_stds"):
        _close(getattr(tdp, f), getattr(jdp, f), err_msg=f)


def _blocks(B, seed):
    """``B`` per-block Welford states ``(W, mean, raw)`` and a centre."""
    rng = np.random.default_rng(seed)
    W = rng.uniform(5.0, 50.0, B).astype(np.float32)
    m = (0.2 * rng.standard_normal((B, N))).astype(np.float32)
    A = rng.standard_normal((B, N, 2 * N))
    raw = (np.einsum("bik,bjk->bij", A, A) * W[:, None, None] / (2 * N)).astype(np.float32)
    return W, m, raw, (0.1 * rng.standard_normal(N)).astype(np.float32)


def test_pool_dense_welford_and_combine_match():
    tp, jp, _ = _full_adapt_pair(12, 9)
    for got, want in zip(t_pool_welford(tp), j_pool_welford(jp)):
        _close(got, want)
    W, m, raw, center = _blocks(6, 10)
    got = t_combine(*(torch.from_numpy(x) for x in (W, m, raw, center)))
    want = j_combine(*(jnp.asarray(x) for x in (W, m, raw, center)))
    for g, w in zip(got, want):
        _close(g, w)
    # the combination is exact: it matches a float64 merge of the blocks
    Wt = W.astype(np.float64).sum()
    mt = (W[:, None] * m).sum(0) / Wt
    rt = (raw + W[:, None, None] * np.einsum("bi,bj->bij", m - mt, m - mt)).sum(0)
    _close(got[1], mt)
    _close(got[2], rt, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("finite", [True, False], ids=["refresh", "kept_factor"])
def test_dense_boundary_potential_matches(finite):
    """The chunk-boundary refresh from per-block states; an indefinite
    pooled covariance keeps the previous factor and latches the failure."""
    tp, jp, _ = _full_adapt_pair(12, 11)
    tp = t_cc.cross_chain_potential_pool(tp, True)
    jp = j_cc.cross_chain_potential_pool(jp, True)
    B = 3
    Wf, mf, rf, center = _blocks(B, 12)
    Wb, mb, rb, _ = _blocks(B, 13)
    if not finite:
        rf[:, 1, 1] = -1e4
    outs = dict(dense_fg_w=Wf, dense_fg_mean=mf, dense_fg_raw=rf, dense_bg_w=Wb,
                dense_bg_mean=mb, dense_bg_raw=rb, n_samples=np.float32(40.0),
                prev_update=np.float32(22.0), window=np.float32(28.0))
    got = t_boundary(tp, {k: torch.tensor(v) for k, v in outs.items()},
                     torch.from_numpy(center), C)
    want = j_boundary(jp, {k: jnp.asarray(v) for k, v in outs.items()}, jnp.asarray(center), C)
    _assert_full_adapt_close(got, want)
    assert bool(got.chol_failed.all()) is (not finite)
    if not finite:
        _close(got.chol, tp.chol)
    # each chain carries 1/C of the pooled state: pooling the rows again
    # gives back the combined state
    for got_, want_ in zip(t_pool_welford(got)[:6], j_pool_welford(want)[:6]):
        _close(got_, want_, atol=1e-3)


def test_pooled_tune_schedule_matches():
    got = [t_schedule(t) for t in range(1000)]
    assert got == [j_schedule(t) for t in range(1000)]
    # the slice's path: 500 tune draws run in chunks 10, 10, 30, 50, 100 x 4
    done, chunks = 0, []
    while done < 500:
        chunks.append(min(t_schedule(done), 500 - done))
        done += chunks[-1]
    assert chunks == [10, 10, 30, 50, 100, 100, 100, 100]


def _jax_dense_state_numpy(adapt: bool):
    """A chain-batched JAX ChainState with a dense metric, as the named
    numpy leaves ``convert`` takes."""
    from littlemcmc_tpu.base import NUTSConfig, init_chain_state
    from littlemcmc_tpu.models import StandardNormal

    model = StandardNormal(N)
    xs = _samples(4, 14)
    cov = jnp.asarray(np.cov(xs.reshape(-1, N).T).astype(np.float32) + np.eye(N, dtype=np.float32))

    def init(k, q):
        if adapt:
            pot = j_qp.QuadPotentialFullAdapt.create(N, initial_mean=q, initial_cov=cov,
                                                     initial_weight=10.0, adaptation_window=2)
            for i in range(3):
                pot = pot.update(q * (i + 2.0), q, True)
        else:
            pot = j_qp.QuadPotentialFull.create(cov)
        return init_chain_state(k, q, pot, NUTSConfig(), model.logp_grad)

    state = jax.jit(jax.vmap(init))(jax.random.split(jax.random.key(3), C), jnp.asarray(xs[0]))
    leaves = jax.tree_util.tree_flatten_with_path(state)[0]
    return {".".join(k.name for k in path): np.asarray(v) for path, v in leaves
            if path[0].name != "rng_key"}


@pytest.mark.parametrize("adapt", [False, True], ids=["full", "full_adapt"])
def test_convert_round_trips_dense_potentials(adapt):
    d = _jax_dense_state_numpy(adapt)
    state = chain_state_from_numpy(d, device="cpu")
    pot = state.potential
    assert isinstance(pot, t_qp.QuadPotentialFullAdapt if adapt else t_qp.QuadPotentialFull)
    back = chain_state_to_numpy(state)
    assert back.keys() == d.keys()
    for k in d:
        assert back[k].dtype == d[k].dtype, k
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)
    if adapt:
        assert int(pot.n_samples[0]) == 3 and int(pot.window[0]) == 4
        assert pot.window_multiplier == 2.0 and pot.regularize
