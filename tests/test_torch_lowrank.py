"""The port's low-rank metric and spiked Gaussian held against the JAX package.

- (a) ``_orthonormal_columns`` and ``_effective_eigenvalues``, ``create``'s
  start basis (bit for bit: both come from numpy), the metric's velocity,
  kinetic energy and momentum transform at a fixed ``zeta``, and 150
  chain-batched ``update`` steps across window swaps and the ring buffer's
  readiness;
- (b) the cross-chain pool's ``_pooled_lowrank`` and
  ``lowrank_boundary_refresh``;
- (c) ``SpikedGaussian``: its data bit for bit, logp and grad;
- (d) the trajectory op's plain version at ``metric="lowrank"`` (body 4)
  against ``build_trajectory_op(metric="lowrank", interpret=True)``, and
  the fused NUTS and HMC ops' plain versions against the JAX ops in
  interpret mode, tune and draw chunks;
- (e) ``convert`` of a JAX low-rank state;
- (f) ``sample`` of both packages on a small spiked Gaussian, per chain
  and pooled, against each other within Monte Carlo error, and the engine
  stamps of NUTS and HMC;
- (g) the ``buf_fill`` staleness gate after a fused chunk.

Both sides compute in float32. Sums of products (the thin matvecs, Cholesky
factors, sums over chains) round in other orders in the two packages: the
deterministic pieces are held within 1e-5 relative (1e-4 for the 150-step
update, whose basis iterates on its own output), and the ops tree for tree
(NUTS) or chain for chain (HMC), at least 15 of 16 chains agreeing per
draw, numbers held on the chain-draws whose block (NUTS) or chain (HMC)
agreed so far, as ``tests/test_torch_fused.py`` does. The JAX functions
run jitted over a few shapes, to keep the XLA compiles of this process few.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import littlemcmc_tpu as lmc
import littlemcmc_torch as lt
import littlemcmc_tpu.quadpotential as j_qp
from littlemcmc_tpu import models as jm
from littlemcmc_tpu.base import HMCConfig as JHMCConfig
from littlemcmc_tpu.base import NUTSConfig as JNUTSConfig
from littlemcmc_tpu.ops import build_trajectory_op
from littlemcmc_tpu.ops.fused_hmc_pallas import build_fused_hmc_op
from littlemcmc_tpu.ops.fused_nuts_pallas import build_fused_nuts_op
from littlemcmc_tpu.parallel import cross_chain as j_cc
import littlemcmc_torch.quadpotential as t_qp
from littlemcmc_torch import models as tm
from littlemcmc_torch.base import HMCConfig, NUTSConfig
from littlemcmc_torch.convert import chain_state_from_numpy, chain_state_to_numpy
from littlemcmc_torch.nuts import fused_metric_after
from littlemcmc_torch.ops.fused_hmc import fused_hmc
from littlemcmc_torch.ops.fused_nuts import WELFORD_KEYS, fused_nuts
from littlemcmc_torch.ops.nuts_trajectory import build_lowrank_fac, trajectory
from littlemcmc_torch.parallel import cross_chain as t_cc

torch.set_num_threads(1)

C, N, K, M = 4, 6, 2, 8  # chains, dimensions, rank, ring buffer
CB = 8
SEED = (2 ** 31 - 77, 5)
RTOL = ATOL = 1e-5
LOWRANK = ("var", "stds", "inv_stds", "n_samples", "window", "vecs", "lam", "alpha",
           "lam_w", "lam_s2", "alpha_s2", "buf", "buf_pos", "buf_fill")
WELFORD = ("w_sum", "w_sum2", "mean", "raw_var")
FLAGS = ("depth", "n_leaves", "diverging", "turning")
HMC_FLAGS = ("n_steps", "accepted", "diverging")
DA_KEYS = ("da_log_step", "da_log_bar", "da_hbar", "da_count", "da_mu")


def _close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=err_msg)


def _assert_lowrank_close(t, j, rtol=RTOL, atol=ATOL):
    for f in LOWRANK:
        _close(getattr(t, f), getattr(j, f), rtol, atol, err_msg=f)
    for side in ("fg", "bg"):
        for f in WELFORD:
            _close(getattr(getattr(t, side), f), getattr(getattr(j, side), f), rtol, atol,
                   err_msg=f"{side}.{f}")


def _samples(steps, seed, n=N):
    """Spiked samples, one per chain and step: ``(steps, C, n)``."""
    rng = np.random.default_rng(seed)
    A = np.eye(n) * rng.uniform(0.5, 2.0, n)
    A[:, 0] += 3.0 * rng.standard_normal(n)
    return (rng.standard_normal((steps, C, n)) @ A.T + 0.2).astype(np.float32)


# --------------------------------------------------------------------------
# (a) the metric
# --------------------------------------------------------------------------

def test_orthonormal_columns_and_effective_eigenvalues_match():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((C, 10, 3)).astype(np.float32) * [1.0, 3.0, 0.2]
    got = t_qp._orthonormal_columns(torch.from_numpy(A))
    _close(got, jax.vmap(j_qp._orthonormal_columns)(jnp.asarray(A)))
    # positive-R sign: the first column keeps the direction of A's
    assert bool(((got[..., 0] * torch.from_numpy(A[..., 0])).sum(-1) > 0).all())
    s2 = rng.uniform(0.0, 50.0, (C, 3)).astype(np.float32)
    w = np.array([0.0, 0.5, 7.0, 300.0], np.float32)
    _close(t_qp._effective_eigenvalues(torch.from_numpy(s2), torch.from_numpy(w)[:, None], 100.0),
           j_qp._effective_eigenvalues(jnp.asarray(s2), jnp.asarray(w)[:, None], 100.0))


def test_create_start_basis_is_bit_for_bit():
    for n, k in ((N, K), (100, 8), (5, 8)):
        t = t_qp.QuadPotentialLowRankAdapt.create(torch.zeros(n), rank=k)
        j = j_qp.QuadPotentialLowRankAdapt.create(n, rank=k)
        np.testing.assert_array_equal(t.vecs.numpy(), np.asarray(j.vecs))
        assert t.rank == j.rank == min(k, n) and t.buffer_size == j.buffer_size


def _pushed_pair(seed):
    """A chain-batched low-rank metric of each package away from its inert
    start: an orthonormal basis, eigenvalues and a bulk of its own per
    chain."""
    rng = np.random.default_rng(seed)
    vecs = np.linalg.qr(rng.standard_normal((C, N, K)))[0].astype(np.float32)
    fields = dict(vecs=vecs, lam=rng.uniform(0.5, 30.0, (C, K)).astype(np.float32),
                  alpha=rng.uniform(0.3, 2.0, C).astype(np.float32))
    var = rng.uniform(0.2, 5.0, (C, N)).astype(np.float32)
    jp = jax.vmap(lambda m, v: j_qp.QuadPotentialLowRankAdapt.create(
        N, initial_mean=m, initial_diag=v, initial_weight=10.0, rank=K))(
            jnp.zeros((C, N)), jnp.asarray(var))
    jp = jp.replace(**{k: jnp.asarray(v) for k, v in fields.items()})
    tp = t_qp.QuadPotentialLowRankAdapt.create(torch.zeros(C, N), torch.from_numpy(var),
                                               initial_weight=10.0, rank=K)
    tp = tp.replace(**{k: torch.from_numpy(v) for k, v in fields.items()})
    return tp, jp


def test_velocity_kinetic_and_momentum_transform_match():
    tp, jp = _pushed_pair(2)
    rng = np.random.default_rng(3)
    p = rng.standard_normal((C, N)).astype(np.float32)
    zeta = rng.standard_normal((C, N)).astype(np.float32)
    pt = torch.from_numpy(p)
    _close(tp.velocity(pt), jax.vmap(lambda pot, x: pot.velocity(x))(jp, jnp.asarray(p)))
    _close(tp.kinetic(pt), jax.vmap(lambda pot, x: pot.kinetic(x))(jp, jnp.asarray(p)))
    # sample_momentum's transform p = S^-1 C^-1/2 zeta at a fixed zeta
    want = jax.vmap(lambda pot, z: pot.inv_stds * pot._corr_matvec(z, -0.5))(
        jp, jnp.asarray(zeta))
    got = tp.inv_stds * tp._corr_matvec(torch.from_numpy(zeta), -0.5)
    _close(got, want)
    # drawn from the density the kinetic energy measures: its velocity
    # S C S p is S C^(1/2) zeta
    _close(tp.velocity(got), tp.stds * tp._corr_matvec(torch.from_numpy(zeta), 0.5),
           rtol=1e-4, atol=1e-4)


def test_update_150_steps_match():
    """Windows of 40 draws (a swap at 40, 80, 120 tuned draws), the ring
    buffer's readiness after 8, non-tuning draws that change nothing."""
    xs = _samples(150, 4)
    tuning = np.ones(150, bool)
    tuning[[5, 60]] = False
    jp = jax.vmap(lambda m: j_qp.QuadPotentialLowRankAdapt.create(
        N, initial_mean=m, initial_weight=10.0, adaptation_window=40, rank=K,
        buffer_size=M))(jnp.asarray(xs[0]))
    upd = jax.jit(jax.vmap(lambda pot, x, t: pot.update(x, x, t), in_axes=(0, 0, None)))
    tp = t_qp.QuadPotentialLowRankAdapt.create(torch.from_numpy(xs[0]), initial_weight=10.0,
                                               adaptation_window=40, rank=K, buffer_size=M)
    for i, (x, tu) in enumerate(zip(xs, tuning)):
        jp = upd(jp, jnp.asarray(x), bool(tu))
        tp = tp.update(torch.from_numpy(x), None, bool(tu))
        if i == 5:  # not ready yet: the basis has not moved
            np.testing.assert_array_equal(tp.vecs.numpy(), np.asarray(jp.vecs))
    assert int(tp.n_samples[0]) == 148 and int(tp.buf_fill[0]) == M
    assert float(tp.lam.max()) > 2.0  # the spike was found
    # the basis iterates on its own output for 140 draws: 1e-4
    _assert_lowrank_close(tp, jp, rtol=1e-4, atol=1e-4)
    tp.raise_ok()


# --------------------------------------------------------------------------
# (b) the cross-chain pool
# --------------------------------------------------------------------------

def test_pooled_lowrank_and_boundary_refresh_match():
    xs = _samples(30, 5)
    jp = jax.vmap(lambda m: j_qp.QuadPotentialLowRankAdapt.create(
        N, initial_mean=m, initial_weight=10.0, rank=K, buffer_size=M))(jnp.asarray(xs[0]))
    upd = jax.jit(jax.vmap(lambda pot, x: pot.update(x, x, True)))
    tp = t_qp.QuadPotentialLowRankAdapt.create(torch.from_numpy(xs[0]), initial_weight=10.0,
                                               rank=K, buffer_size=M)
    for x in xs[:-1]:
        jp = upd(jp, jnp.asarray(x))
        tp = tp.update(torch.from_numpy(x), None, True)
    last = xs[-1]
    _assert_lowrank_close(t_cc._pooled_lowrank(tp, torch.from_numpy(last)),
                          jax.jit(j_cc._pooled_lowrank)(jp, jnp.asarray(last)))
    _assert_lowrank_close(t_cc.lowrank_boundary_refresh(tp, torch.from_numpy(last)),
                          jax.jit(j_cc.lowrank_boundary_refresh)(jp, jnp.asarray(last)))
    # the pool entry point: with samples, the batch subspace iteration;
    # without, the diagonal only; outside tuning, nothing
    pooled = t_cc.cross_chain_potential_pool(tp, True, torch.from_numpy(last))
    _assert_lowrank_close(pooled, j_cc.cross_chain_potential_pool(
        jp, jnp.asarray(True), samples=jnp.asarray(last)))
    diag_only = t_cc.cross_chain_potential_pool(tp, True)
    _close(diag_only.vecs, tp.vecs)
    _close(diag_only.var, j_cc.cross_chain_potential_pool(jp, jnp.asarray(True)).var)
    assert t_cc.cross_chain_potential_pool(tp, False, torch.from_numpy(last)) is tp


# --------------------------------------------------------------------------
# (c) the spiked Gaussian
# --------------------------------------------------------------------------

def test_spiked_gaussian_matches_jax_model():
    j, t = jm.SpikedGaussian(40), tm.SpikedGaussian(40, device="cpu")
    for k in ("V", "lam", "scales", "true_var"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k), err_msg=k)
    np.testing.assert_array_equal(t.trajectory_spec().consts[0].numpy(),
                                  np.asarray(j._V))
    rng = np.random.default_rng(6)
    q = (rng.standard_normal((16, 40)) * np.sqrt(j.true_var)).astype(np.float32)
    lj, gj = jax.vmap(j.logp_grad)(jnp.asarray(q))
    lt_, gt = t.batched_logp_grad(torch.from_numpy(q))
    _close(lt_, lj, rtol=1e-5, atol=1e-3)
    _close(gt, gj, rtol=1e-5, atol=1e-5 * float(np.abs(np.asarray(gj)).max()))
    l1, g1 = t.logp_grad(torch.from_numpy(q[3]))
    _close(l1, lj[3], rtol=1e-5, atol=1e-3)
    _close(g1, gj[3], rtol=1e-5, atol=1e-5 * float(np.abs(np.asarray(gj)).max()))


def test_spiked_gaussian_draws_have_its_covariance():
    """``draws`` is linear in z, ``z -> z Bᵀ``; ``B Bᵀ`` is the JAX model's
    covariance ``S(I + V(Λ−I)Vᵀ)S`` to float32 rounding (rtol 1e-5 of its
    largest entry)."""
    j, t = jm.SpikedGaussian(40), tm.SpikedGaussian(40, device="cpu")
    Bt = t.draws(np.eye(40)).astype(np.float64)
    cov = j.scales[:, None] * (np.eye(40) + (j.V * (j.lam - 1.0)) @ j.V.T) * j.scales
    np.testing.assert_allclose(Bt.T @ Bt, cov, rtol=0, atol=1e-5 * np.abs(cov).max())
    np.testing.assert_allclose(np.diag(Bt.T @ Bt), j.true_var, rtol=1e-5)


# --------------------------------------------------------------------------
# (d) the ops against the JAX ops in interpret mode
# --------------------------------------------------------------------------

NS = 12  # the spiked model of the op checks


@pytest.fixture(scope="module")
def spiked():
    """The JAX and the port's spiked Gaussian, and a metric near the truth:
    the scales, the model's spikes as the basis with eigenvalues off by up
    to 20%, and a bulk of 0.9."""
    j, t = jm.SpikedGaussian(NS, rank=2, spikes=(50.0, 9.0)), tm.SpikedGaussian(
        NS, rank=2, spikes=(50.0, 9.0), device="cpu")
    V = j.V.astype(np.float32)
    lam = (j.lam * [1.2, 0.85]).astype(np.float32)
    return j, t, V, lam, np.float32(0.9)


def test_lowrank_trajectory_plain_matches_jax(spiked):
    """One transition of 16 chains, block for block, from the model's
    draws with momenta of the metric."""
    want = _lowrank_trajectory_check(spiked, 0.5, 8, seed=7)
    assert want["depth"].mean() > 1.5


def test_lowrank_trajectory_plain_matches_jax_to_deeper_merges(spiked):
    """The same at a step of 0.08 and a depth cap of 7: mean depth above
    3, so that the merges of subtrees of 2, 4 and more leaves, and the
    U-turn checks across them, run (the block transition caches their
    velocities; the plain version computes them where the JAX kernel
    does)."""
    want = _lowrank_trajectory_check(spiked, 0.08, 7, seed=8)
    assert want["depth"].mean() > 3.0
    assert int(want["depth"].max()) >= 5


def _lowrank_trajectory_check(spiked, eps0, D, seed):
    """One transition of 16 chains, block for block, the plain version
    against the JAX op in interpret mode: the flags on all chains but one,
    the proposals within 1e-4 sd and the energies within 1e-4 on those
    that agree. Returns the JAX op's outputs."""
    j, t, V, lam, alpha = spiked
    C_ = 16
    rng = np.random.default_rng(seed)
    q = t.draws(rng.standard_normal((C_, NS)))
    stds = (j.scales * rng.uniform(0.8, 1.25, (C_, NS))).astype(np.float32)
    zeta = rng.standard_normal((C_, NS))
    p = ((alpha ** -0.5 * zeta + ((zeta @ V) * (lam ** -0.5 - alpha ** -0.5)) @ V.T)
         / stds).astype(np.float32)
    eps = (eps0 * rng.uniform(0.8, 1.2, C_)).astype(np.float32)
    mdc = np.full(C_, D, np.int32)
    mdc[::5] = D - 2
    lp, g = (np.asarray(x) for x in jax.vmap(j.logp_grad)(jnp.asarray(q)))
    op = build_trajectory_op(j.pallas_trajectory_spec(), NS, D, 1000.0, "leapfrog",
                             interpret=True, chain_block=CB, metric="lowrank")
    want = jax.tree.map(np.asarray, op(q, p, g, lp, eps, mdc,
                                       (stds, V, lam, alpha), jnp.asarray(SEED, jnp.int32)))
    tt = [torch.from_numpy(np.array(x)) for x in (q, p, g, lp, eps, mdc)]
    fac = build_lowrank_fac(torch.from_numpy(V), torch.from_numpy(lam), torch.tensor(alpha))
    launches = trajectory.launches
    got = trajectory(*tt, torch.from_numpy(stds), SEED, spec=t.trajectory_spec(),
                     max_treedepth=D, Emax=1000.0, chain_block=CB, metric="lowrank", fac=fac)
    assert trajectory.launches == launches  # the CPU runs the plain version
    got = {k: v.numpy() for k, v in got.items()}
    agree = np.all([got[k] == want[k] for k in FLAGS], axis=0)
    assert agree.sum() >= C_ - 1, agree
    sd = np.sqrt(j.true_var)
    np.testing.assert_allclose(got["q"][agree] / sd, want["q"][agree] / sd, atol=1e-4, rtol=0)
    for k in ("energy", "logp", "log_size"):
        np.testing.assert_allclose(got[k][agree], want[k][agree], atol=1e-4, rtol=1e-4)
    return want


def _fused_args(j, t, V, lam, alpha, seed, C_=16):
    rng = np.random.default_rng(seed)
    f = np.float32
    q = t.draws(rng.standard_normal((C_, NS)))
    lp, g = (np.asarray(x) for x in jax.vmap(j.logp_grad)(jnp.asarray(q)))
    ls = (-0.8 + rng.uniform(-0.1, 0.1, C_)).astype(f)
    sd = np.sqrt(j.true_var)
    x = dict(q=q, grad=g, logp=lp, iter_count=np.full(C_, 300.0, f), da_log_step=ls,
             da_log_bar=ls.copy(), da_hbar=np.zeros(C_, f), da_count=np.full(C_, 40.0, f),
             da_mu=(ls + np.log(10.0)).astype(f),
             var=(j.scales ** 2 * rng.uniform(0.8, 1.25, (C_, NS))).astype(f))
    w = dict(fg_mean=(sd * rng.standard_normal((C_, NS)) * 0.3).astype(f),
             fg_raw=(40.0 * sd ** 2 * rng.uniform(0.5, 2.0, (C_, NS))).astype(f),
             fg_w=np.full(C_, 40.0, f), fg_w2=np.full(C_, 40.0, f),
             bg_mean=(sd * rng.standard_normal((C_, NS)) * 0.3).astype(f),
             bg_raw=(8.0 * sd ** 2 * rng.uniform(0.5, 2.0, (C_, NS))).astype(f),
             bg_w=np.full(C_, 8.0, f), bg_w2=np.full(C_, 8.0, f),
             n_samples=np.full(C_, 48.0, f), window=np.full(C_, 50.0, f))
    return x, tuple(w[k] for k in WELFORD_KEYS)


@pytest.mark.parametrize("sampler", ["nuts", "hmc"])
@pytest.mark.parametrize("T,tuning", [(3, False), (4, True)], ids=["draw_chunk", "tune_chunk"])
def test_fused_lowrank_plain_matches_jax_op(spiked, sampler, T, tuning):
    """The fused op's low-rank branch, chain-draw for chain-draw: a draw
    chunk, and a tune chunk with the per-chain Welford steps across a window
    swap (at draw 2), step sizes held."""
    j, t, V, lam, alpha = spiked
    x, welford = _fused_args(j, t, V, lam, alpha, seed=T + 11)
    welford = welford if tuning else None
    keys = ("q", "grad", "logp", "iter_count") + DA_KEYS
    if sampler == "nuts":
        jcfg, cfg, build, op = (JNUTSConfig(adapt_step_size=False),
                                NUTSConfig(adapt_step_size=False), build_fused_nuts_op,
                                fused_nuts)
    else:
        jcfg, cfg, build, op = (JHMCConfig(adapt_step_size=False),
                                HMCConfig(adapt_step_size=False), build_fused_hmc_op, fused_hmc)
    jop = build(j.pallas_trajectory_spec(), NS, T, tuning, tuning, jcfg, window_multiplier=2.0,
                chain_block=CB, interpret=True, pack=1, metric="lowrank", lowrank_k=2)
    want = jop(*(jnp.asarray(x[k]) for k in keys), jnp.asarray(x["var"]),
               None if welford is None else tuple(map(jnp.asarray, welford)),
               jnp.asarray(SEED, jnp.int32), lowrank_fac=(V, lam, alpha))
    want = {k: np.asarray(v) for k, v in want.items() if v is not None}
    tt = {k: torch.from_numpy(np.array(v)) for k, v in x.items()}
    fac = build_lowrank_fac(torch.from_numpy(V), torch.from_numpy(lam), torch.tensor(alpha))
    launches = op.launches
    got = op(*(tt[k] for k in keys), tt["var"], None, SEED, spec=t.trajectory_spec(), T=T,
             tuning=tuning, config=cfg, metric="lowrank", window_multiplier=2.0,
             chain_block=CB, fac=fac,
             welford=None if welford is None else tuple(map(torch.from_numpy, welford)))
    assert op.launches == launches  # the CPU runs the plain version
    got = {k: v.numpy() for k, v in got.items() if v is not None}
    flags = FLAGS if sampler == "nuts" else HMC_FLAGS
    agree = np.all([got[k] == want[k] for k in flags], axis=0)  # (T, C)
    assert (agree.sum(1) >= agree.shape[1] - 1).all(), agree
    unit = CB if sampler == "nuts" else 1
    block = agree.reshape(T, -1, unit).all(-1)
    held = np.repeat(np.cumprod(block, axis=0).astype(bool), unit, axis=1)
    sd = np.sqrt(j.true_var)
    np.testing.assert_allclose(got["trace"][held] / sd, want["trace"][held] / sd, atol=1e-4,
                               rtol=0)
    # a divergent trajectory's energy (thousands, far past Emax) is chaotic
    # in fp32: energies are held on the calm chain-draws
    calm = held & ~want["diverging"]
    for k in ("energy", "model_logp", "energy_error"):
        np.testing.assert_allclose(got[k][calm], want[k][calm], atol=1e-3, rtol=1e-4,
                                   err_msg=k)
    if sampler == "hmc":
        np.testing.assert_array_equal(got["path_length"], want["path_length"])
    if tuning:
        rows = held[-1]
        for k in ("var",) + WELFORD_KEYS:
            g_, w_ = got[k], want[k]
            scale = np.abs(w_).max() + 1.0
            np.testing.assert_allclose(g_[rows] / scale, w_[rows] / scale, atol=1e-5,
                                       err_msg=k)


# --------------------------------------------------------------------------
# (e) convert
# --------------------------------------------------------------------------

def test_convert_carries_a_jax_lowrank_state():
    xs = _samples(12, 8)
    jp = jax.vmap(lambda m: j_qp.QuadPotentialLowRankAdapt.create(
        N, initial_mean=m, initial_weight=10.0, rank=K, buffer_size=M,
        adaptation_window_multiplier=2.0, lam_clip=50.0))(jnp.asarray(xs[0]))
    upd = jax.jit(jax.vmap(lambda pot, x: pot.update(x, x, True)))
    for x in xs:
        jp = upd(jp, jnp.asarray(x))
    leaves = {f"potential.{k}": np.asarray(getattr(jp, k)) for k in LOWRANK}
    for side in ("fg", "bg"):
        for k in WELFORD:
            leaves[f"potential.{side}.{k}"] = np.asarray(getattr(getattr(jp, side), k))
    rng = np.random.default_rng(9)
    leaves.update(q=xs[-1], q_grad=-xs[-1], logp=rng.standard_normal(C).astype(np.float32),
                  iter_count=np.full(C, 12, np.int32),
                  **{f"da.{k}": np.full(C, 0.1, np.float32) for k in
                     ("log_step", "log_bar", "hbar", "mu")},
                  **{"da.count": np.full(C, 12, np.int32)})
    state = chain_state_from_numpy(leaves, window_multiplier=2.0, lam_clip=50.0)
    pot = state.potential
    assert isinstance(pot, t_qp.QuadPotentialLowRankAdapt)
    assert (pot.rank, pot.buffer_size, pot.lam_clip, pot.window_multiplier) == (K, M, 50.0, 2.0)
    _assert_lowrank_close(pot, jp, rtol=0, atol=0)
    back = chain_state_to_numpy(state)
    for k, v in leaves.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # the next update continues as JAX's does
    x = _samples(1, 10)[0]
    _assert_lowrank_close(pot.update(torch.from_numpy(x), None, True),
                          upd(jp, jnp.asarray(x)))


# --------------------------------------------------------------------------
# (f) sample and the engine election
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pooled", [False, True], ids=["per_chain", "pooled"])
def test_sample_lowrank_matches_jax(pooled):
    """SpikedGaussian(16), 8 chains, 150 + 150, ``jitter+adapt_lowrank``:
    per chain on the port's tree (``per_draw_lowrank``) and pooled on its
    fused op (``fused_lowrank_pooled``), against JAX's run (its XLA tree on
    the CPU). Both posteriors' means within 5 Monte Carlo standard errors
    of 0 and of each other, the variance ratios within 30% of 1, in the
    parameters' sds; divergences under 5%."""
    n, chains, tune, draws = 16, 8, 150, 150
    jmodel, tmodel = jm.SpikedGaussian(n), tm.SpikedGaussian(n, device="cpu")
    kw = dict(model_ndim=n, chains=chains, tune=tune, draws=draws, random_seed=3,
              init="jitter+adapt_lowrank", cross_chain_adapt=pooled, progressbar=False)
    jrep, trep = {}, {}
    jtr, jst = lmc.sample(jmodel.logp_grad, perf_report=jrep, **kw)
    ttr, tst = lt.sample(tmodel.logp_grad, device="cpu", perf_report=trep, **kw)
    want = "fused_lowrank_pooled" if pooled else "per_draw_lowrank"
    assert trep["engine"] == want and jrep["engine"].startswith("per_draw_lowrank")
    assert trep["trajectory"] == ("plain" if pooled else "tensor")
    sd = np.sqrt(jmodel.true_var)
    for tr in (np.asarray(jtr), ttr):
        flat = tr.reshape(-1, n)
        mcse = np.sqrt(jmodel.true_var / (chains * draws / 4.0))  # ESS at least 1/4
        assert (np.abs(flat.mean(0)) < 5 * mcse).all()
        assert np.abs(flat.var(0) / jmodel.true_var - 1).max() < 0.3
    jm_, tm_ = np.asarray(jtr).reshape(-1, n).mean(0), ttr.reshape(-1, n).mean(0)
    assert (np.abs(jm_ - tm_) / sd < 5 * np.sqrt(2.0 / (chains * draws / 4.0))).all()
    assert tst["diverging"].mean() < 0.05 and np.asarray(jst["diverging"]).mean() < 0.05


@pytest.mark.parametrize("step", ["nuts", "hmc"])
@pytest.mark.parametrize("chains,fuse_draws,cross,engine,trajectory_kind", [
    (16, None, None, "per_draw_lowrank", "tensor"),
    (128, None, False, "per_draw_lowrank", "tensor"),
    (128, False, None, "per_draw_lowrank_pooled", "plain"),
    (128, None, None, "fused_lowrank_pooled", "plain"),
], ids=["few_chains", "per_chain", "per_draw", "fused"])
def test_lowrank_engine_stamps(step, chains, fuse_draws, cross, engine, trajectory_kind):
    """The JAX rule (``sampling.py:1040-1049``, ``:1083-1105``, ``:1264-1291``,
    ``:1350-1353``, ``:1387-1398``): per chain below 128 chains or with
    ``cross_chain_adapt=False`` (the tree: no kernel models per-chain
    bases), pooled from 128 on, fused by default, per-draw with
    ``fuse_draws=False`` (HMC there on its tensor trajectory: the HMC
    kernel is diagonal-only)."""
    model = tm.SpikedGaussian(4, rank=2, device="cpu")
    rep = {}
    kw = dict(model_ndim=4, chains=chains, tune=1, draws=1, random_seed=1, device="cpu",
              init="jitter+adapt_lowrank", fuse_draws=fuse_draws, cross_chain_adapt=cross,
              progressbar=False, perf_report=rep, compute_convergence_checks=False)
    if step == "hmc":
        kw["step"] = lt.HamiltonianMC(model_ndim=4)
        if trajectory_kind == "plain" and engine.startswith("per_draw"):
            trajectory_kind = "tensor"
    tr, _ = lt.sample(model.logp_grad, **kw)
    assert tr.shape == (chains, 1, 4) and np.isfinite(tr).all()
    assert (rep["engine"], rep["trajectory"]) == (engine, trajectory_kind)


def test_init_nuts_lowrank():
    start, step = lt.init_nuts(model_ndim=6, init="adapt_lowrank", random_seed=1, device="cpu")
    assert isinstance(step.potential, t_qp.QuadPotentialLowRankAdapt)
    assert step.potential.rank == 6 and tuple(start.shape) == (6,)
    assert t_qp.isquadpotential(step.potential) and not t_qp.isquadpotential(start)
    model = tm.SpikedGaussian(6, rank=2, device="cpu")
    rep = {}
    tr, _ = lt.sample(model.logp_grad, model_ndim=6, chains=8, tune=20, draws=10, step=step,
                      random_seed=2, device="cpu", perf_report=rep, progressbar=False,
                      compute_convergence_checks=False)
    assert rep["engine"] == "per_draw_lowrank" and np.isfinite(tr).all()


# --------------------------------------------------------------------------
# (g) the staleness gate
# --------------------------------------------------------------------------

def test_buffer_staleness_gate_after_fused_chunk():
    """The fused epilogue leaves n_samples large and zeroes buf_fill
    (:func:`littlemcmc_torch.nuts.fused_metric_after`); the per-chain
    update refills the buffer before moving the basis again, as
    ``tests/test_lowrank.py::test_buffer_staleness_gate_after_fused_chunk``
    holds the JAX side."""
    n, k, m = 8, 2, 6
    rng = np.random.RandomState(1)
    pot = t_qp.QuadPotentialLowRankAdapt.create(torch.zeros(1, n), initial_weight=10.0,
                                                rank=k, buffer_size=m)
    for _ in range(2 * m):
        pot = pot.update(torch.from_numpy(rng.standard_normal((1, n)).astype(np.float32)),
                         None, True)
    # a draw chunk's epilogue: the variances as they were, buf_fill zeroed
    outs = {"q": torch.zeros(1, n)}
    pot = fused_metric_after(pot.replace(n_samples=torch.full((1,), 500, dtype=torch.int32)),
                             outs, False, True, None, 1)
    assert int(pot.buf_fill[0]) == 0
    v_frozen = pot.vecs.clone()
    for _ in range(m - 1):
        pot = pot.update(torch.from_numpy(rng.standard_normal((1, n)).astype(np.float32)),
                         None, True)
        assert torch.equal(pot.vecs, v_frozen)
    pot = pot.update(torch.from_numpy(rng.standard_normal((1, n)).astype(np.float32)),
                     None, True)
    assert not torch.allclose(pot.vecs, v_frozen)
