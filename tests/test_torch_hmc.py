"""The port's classic HMC held against the JAX package on the CPU.

- (i) the HMC trajectory op's plain version against
  ``build_hmc_trajectory_op(interpret=True)``, with the same per-chain
  step counts;
- (ii) the fused HMC op's plain version against ``build_fused_hmc_op(
  metric="dense", interpret=True)``: a static draw chunk, an ``adapt_dense``
  tune chunk across a window swap with the step size held, and one with
  the step size adapting;
- (iii) ``sample(step=HamiltonianMC(...))`` of both packages on the 20-d
  correlated Gaussian: the diag metric on the per-draw engine, and
  ``adapt_full`` pooled across 128 chains on the fused engine;
- (iv) the stats' names and dtypes, and the engine election.

Both packages draw the same counter streams, so (i) and (ii) compare
chain for chain. HMC's chains share nothing during a draw (each draws its
own path length and accept uniform), so a chain that decides otherwise
moves only itself: it is held until its first disagreement. The JAX side's
correlated body is a test-local spec in full float32; its dense velocity
stays the package's bf16x3 split, about 2^-21 relative.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import littlemcmc_tpu as lmc
import littlemcmc_torch as lt
from littlemcmc_tpu import models as jm
from littlemcmc_tpu.base import HMCConfig as JHMCConfig
from littlemcmc_tpu.ops import PallasModelSpec
from littlemcmc_tpu.ops.fused_hmc_pallas import build_fused_hmc_op
from littlemcmc_tpu.ops.fused_nuts_pallas import combine_dense_welford as j_combine
from littlemcmc_tpu.ops.hmc_trajectory_pallas import build_hmc_trajectory_op
from littlemcmc_tpu.ops.nuts_trajectory_pallas import padded_dim
from littlemcmc_tpu.step_sizes import DualAverageState as JDualAverage
from littlemcmc_tpu.step_sizes import dual_average_update
from littlemcmc_torch import models as tm
from littlemcmc_torch.base import HMCConfig
from littlemcmc_torch.ops.hmc_trajectory import hmc_trajectory
from littlemcmc_torch.ops.fused_hmc import fused_hmc
from littlemcmc_torch.ops.fused_nuts import combine_dense_welford

torch.set_num_threads(1)

SEED = (987654321, -77)
DA_KEYS = ("da_log_step", "da_log_bar", "da_hbar", "da_count", "da_mu")
HMC_FLAGS = ("n_steps", "accepted", "diverging")


def _highest_spec(jmodel, n):
    """The JAX correlated Gaussian's kernel body in full float32."""
    prec = np.zeros((padded_dim(n),) * 2, np.float32)
    prec[:n, :n] = jmodel.prec.astype(np.float32)

    def fn(q, p):
        g = -jnp.dot(q, p, precision="highest", preferred_element_type=jnp.float32)
        return 0.5 * jnp.sum(q * g, axis=1, keepdims=True), g

    return PallasModelSpec(fn, (jnp.asarray(prec),), n)


# --------------------------------------------------------------------------
# (i) the per-draw HMC trajectory op
# --------------------------------------------------------------------------

@pytest.mark.parametrize("body", ["standard_normal", "correlated_gaussian"])
def test_hmc_trajectory_plain_matches_jax(body):
    """(i) one transition, chain for chain, at n = 20 and 16 chains in
    blocks of 8, from stationary inputs and the same step counts (1 to
    24, some chains past the stable step size so that some reject)."""
    n, C, CB = 20, 16, 8
    if body == "standard_normal":
        jmodel, tmodel = jm.StandardNormal(n), tm.StandardNormal(n, device="cpu")
        jspec, chol = jmodel.pallas_trajectory_spec(), np.eye(n)
    else:
        jmodel, tmodel = jm.CorrelatedGaussian(n), tm.CorrelatedGaussian(n, device="cpu")
        jspec, chol = _highest_spec(jmodel, n), np.linalg.cholesky(jmodel.cov)
    rng = np.random.default_rng(11)
    q = (rng.standard_normal((C, n)) @ chol.T).astype(np.float32)
    var = (jmodel.true_var * rng.uniform(0.5, 2.0, (C, n))).astype(np.float32)
    p = (rng.standard_normal((C, n)) / np.sqrt(var)).astype(np.float32)
    base = 0.8 if body == "standard_normal" else 0.15
    eps = (base * rng.uniform(0.5, 1.6, C)).astype(np.float32)
    n_steps = rng.integers(1, 25, C).astype(np.int32)
    lp, g = (np.asarray(x) for x in jax.vmap(jmodel.logp_grad)(jnp.asarray(q)))
    op = build_hmc_trajectory_op(jspec, n, 1000.0, interpret=True, chain_block=CB)
    want = jax.tree.map(np.asarray, op(q, p, g, lp, eps, n_steps, var,
                                       jnp.asarray(SEED, jnp.int32)))
    t = [torch.from_numpy(np.array(x)) for x in (q, p, g, lp, eps, n_steps, var)]
    launches = hmc_trajectory.launches
    got = hmc_trajectory(*t, SEED, spec=tmodel.trajectory_spec(), Emax=1000.0, chain_block=CB)
    assert hmc_trajectory.launches == launches  # the CPU runs the plain version
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(want)
    agree = (got["accepted"] == want["accepted"]) & (got["diverging"] == want["diverging"])
    assert agree.all(), agree
    assert 0 < want["accepted"].sum() < C  # both branches of the accept ran
    sd = np.sqrt(jmodel.true_var)
    np.testing.assert_allclose(got["q"] / sd, want["q"] / sd, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["grad"], want["grad"], atol=1e-4, rtol=1e-4)
    for k in ("logp", "logp_end", "energy", "energy_change"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(got["accept_stat"], want["accept_stat"], atol=1e-6, rtol=1e-4)


def _ragged_inputs(jmodel, n, C, CB, seed):
    """Stationary inputs with ragged step counts within each chain block of
    ``CB``: its first chain at 24 steps and the rest at 1, chain 3 at 20
    steps of a step size past the stable one (its energy grows past Emax
    and stays finite: it diverges mid-trajectory and integrates on), chain
    5 at 0 steps."""
    chol = np.linalg.cholesky(jmodel.cov)
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((C, n)) @ chol.T).astype(np.float32)
    var = (jmodel.true_var * rng.uniform(0.5, 2.0, (C, n))).astype(np.float32)
    p = (rng.standard_normal((C, n)) / np.sqrt(var)).astype(np.float32)
    eps = (0.15 * rng.uniform(0.8, 1.2, C)).astype(np.float32)
    n_steps = np.ones(C, np.int32)
    n_steps[::CB] = 24
    n_steps[3], eps[3] = 20, 0.5
    n_steps[5] = 0
    lp, g = (np.asarray(x) for x in jax.vmap(jmodel.logp_grad)(jnp.asarray(q)))
    return q, p, g, lp, eps, n_steps, var


def test_hmc_ragged_counts_plain_match_jax():
    """(i) with the ragged counts the block HMC transition's lockstep meets
    (:func:`_ragged_inputs`), chain for chain against
    ``build_hmc_trajectory_op(interpret=True)``, whose loop also runs to
    the block's longest count with each chain live to its own
    (``run_hmc_trajectory_values``)."""
    n, C, CB = 20, 16, 8
    jmodel, tmodel = jm.CorrelatedGaussian(n), tm.CorrelatedGaussian(n, device="cpu")
    inputs = _ragged_inputs(jmodel, n, C, CB, 13)
    op = build_hmc_trajectory_op(_highest_spec(jmodel, n), n, 1000.0, interpret=True,
                                 chain_block=CB)
    want = jax.tree.map(np.asarray, op(*inputs, jnp.asarray(SEED, jnp.int32)))
    got = hmc_trajectory(*[torch.from_numpy(np.array(x)) for x in inputs], SEED,
                         spec=tmodel.trajectory_spec(), Emax=1000.0, chain_block=CB)
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_array_equal(got["accepted"], want["accepted"])
    np.testing.assert_array_equal(got["diverging"], want["diverging"])
    assert want["diverging"][3] and np.isfinite(want["energy"][3])
    assert abs(want["energy_change"][3]) > 1000.0
    sd = np.sqrt(jmodel.true_var)
    np.testing.assert_allclose(got["q"] / sd, want["q"] / sd, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["grad"], want["grad"], atol=1e-4, rtol=1e-4)
    for k in ("logp", "logp_end", "energy", "energy_change"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-5)
    # the chain of no steps keeps its start, its energy change 0
    np.testing.assert_array_equal(got["q"][5], inputs[0][5])
    np.testing.assert_array_equal(got["grad"][5], inputs[2][5])
    assert got["energy_change"][5] == 0.0


@pytest.mark.parametrize("metric", ["diag", "dense"])
def test_lockstep_keeps_each_chains_bits(metric):
    """The property the block HMC transition relies on: a chain's result
    is the same to the bit whether its block mates run other counts (the
    block integrates to the longest, each chain frozen past its own) or
    the block holds only copies of it at its own count. Each chain of a
    ragged batch (:func:`_ragged_inputs`) against row ``c`` of a batch of
    copies of chain ``c``, through the plain trajectory with the diagonal
    metric and with a shared dense one."""
    from littlemcmc_torch.integration import INTEGRATOR_COEFFS
    from littlemcmc_torch.ops.hmc_trajectory import hmc_transition
    from littlemcmc_torch.ops.nuts_trajectory import body_logp_grad, metric_velocity

    n, C, CB = 20, 16, 8
    jmodel, tmodel = jm.CorrelatedGaussian(n), tm.CorrelatedGaussian(n, device="cpu")
    q, p, g, lp, eps, n_steps, var = (torch.from_numpy(np.array(x)) for x in
                                      _ragged_inputs(jmodel, n, C, CB, 17))
    spec = tmodel.trajectory_spec()
    cov = torch.from_numpy((0.5 * jmodel.cov + 0.5 * np.diag(np.diag(jmodel.cov)))
                           .astype(np.float32))
    vel = metric_velocity(var if metric == "diag" else cov, metric)
    if metric == "dense":  # chain 3 past the dense metric's stable step size too
        eps[3] = 1.0
    u = torch.from_numpy(np.random.default_rng(3).uniform(size=C).astype(np.float32))

    def run(rows, counts, vel_fn):
        return hmc_transition(lambda x: body_logp_grad(spec, x), vel_fn,
                              INTEGRATOR_COEFFS["leapfrog"], 1000.0, q[rows], p[rows], g[rows],
                              lp[rows], eps[rows], counts, u[rows])

    ragged = run(torch.arange(C), n_steps, vel)
    assert ragged["diverging"][3] and 0 < int(ragged["accepted"].sum()) < C
    for c in range(C):
        rows = torch.full((C,), c)
        alone = run(rows, n_steps[rows], vel if metric == "dense" else
                    metric_velocity(var[rows], "diag"))
        for k, v in ragged.items():
            torch.testing.assert_close(alone[k][c], v[c], rtol=0, atol=0, equal_nan=True,
                                       msg=lambda m, k=k, c=c: f"{k} of chain {c}: {m}")


@pytest.mark.parametrize("chain_block", [1, 8, 16])
def test_hmc_block_predicate_matches_the_kernels(chain_block):
    """``runs_hmc_block_transition`` names the instances that
    ``hmc_block_body()`` of ``csrc/hmc_transition.cuh`` and ``kBlockChains``
    put on the block HMC transition: body 1, per draw with the diagonal
    metric at any chain block, fused with the dense metric in blocks of up
    to 8 chains."""
    import re
    from pathlib import Path

    from littlemcmc_torch.ops.nuts_trajectory import (BODY_IDS, METRIC_IDS,
                                                      runs_hmc_block_transition)

    csrc = Path(__file__).resolve().parents[1] / "littlemcmc_torch" / "ops" / "csrc"
    src = (csrc / "hmc_transition.cuh").read_text()
    fn = re.search(r"constexpr bool hmc_block_body\(\) \{\s*return (.*?);", src, re.S).group(1)
    bodies = {int(b) for b in re.findall(r"BODY == (\d+)", fn)}
    fused_metric, draw_metric = re.search(r"METRIC == \(FUSED \? (k\w+) : (k\w+)\)", fn).groups()
    chains = int(re.search(r"constexpr int kBlockChains = (\d+);",
                           (csrc / "nuts_transition.cuh").read_text()).group(1))
    names = {"kDiag": "diag", "kDense": "dense", "kLowRank": "lowrank"}
    assert bodies == {1} and (names[fused_metric], names[draw_metric]) == ("dense", "diag")
    for body, bid in BODY_IDS.items():
        for metric in METRIC_IDS:
            on = bid in bodies
            assert runs_hmc_block_transition(body, metric, chain_block, fused=False) == (
                on and metric == names[draw_metric])
            assert runs_hmc_block_transition(body, metric, chain_block, fused=True) == (
                on and metric == names[fused_metric] and chain_block <= chains)


# --------------------------------------------------------------------------
# (ii) the fused HMC op
# --------------------------------------------------------------------------

N, C, CB = 6, 16, 8


@pytest.fixture(scope="module")
def models():
    """The JAX model, its body in full float32, and the port's model."""
    jmodel = jm.CorrelatedGaussian(N, rho=0.6)
    return jmodel, _highest_spec(jmodel, N), tm.CorrelatedGaussian(N, rho=0.6, device="cpu")


def _fused_inputs(model, seed):
    """Stationary positions, and a dense metric with the posterior's
    correlations shrunk by half, so that some proposals are rejected."""
    chol = np.linalg.cholesky(model.cov)
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((C, N)) @ chol.T).astype(np.float32)
    cov64 = 0.5 * model.cov + 0.5 * np.diag(np.diag(model.cov))
    cov = cov64.astype(np.float32)
    chol = np.linalg.cholesky(cov64)
    lp, g = (np.asarray(x) for x in jax.vmap(model.logp_grad)(jnp.asarray(q)))
    ls = (np.log(0.45) + rng.uniform(-0.1, 0.1, C)).astype(np.float32)
    f = np.float32
    return dict(q=q, grad=g, logp=lp, iter_count=np.full(C, 250.0, f), da_log_step=ls,
                da_log_bar=ls.copy(), da_hbar=np.zeros(C, f), da_count=np.full(C, 40.0, f),
                da_mu=(ls + np.log(10.0)).astype(f), cov=cov,
                linv=np.linalg.inv(chol).astype(np.float32))


def _welford_seed(seed):
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
    welford = _welford_seed(seed) if tuning else None
    jcfg = JHMCConfig(adapt_step_size=adapt_step_size)
    op = build_fused_hmc_op(jspec, N, T, tuning, False, jcfg, window_multiplier=2.0,
                            interpret=True, chain_block=CB, metric="dense",
                            adapt_dense=tuning)
    want = op(*(jnp.asarray(x[k]) for k in ("q", "grad", "logp", "iter_count") + DA_KEYS),
              jnp.asarray(x["cov"]), None, jnp.asarray(SEED, jnp.int32),
              linv=jnp.asarray(x["linv"]),
              dense_welford=None if welford is None else tuple(map(jnp.asarray, welford)))
    want = {k: np.asarray(v) for k, v in want.items() if v is not None}
    t = {k: torch.tensor(v) for k, v in x.items()}
    launches = fused_hmc.launches
    got = fused_hmc(*(t[k] for k in ("q", "grad", "logp", "iter_count") + DA_KEYS),
                    t["cov"], t["linv"], SEED, spec=tmodel.trajectory_spec(), T=T,
                    tuning=tuning, config=HMCConfig(adapt_step_size=adapt_step_size),
                    window_multiplier=2.0, chain_block=CB,
                    dense_welford=None if welford is None
                    else tuple(torch.tensor(w) for w in welford))
    assert fused_hmc.launches == launches  # the CPU runs the plain version
    got = {k: v.numpy() for k, v in got.items() if v is not None}
    assert set(got) == set(want)
    return jmodel, x, welford, got, want


def _held(got, want):
    """Per (draw, chain): the chain agreed on its step count, accept and
    divergence at this draw and every earlier one."""
    agree = np.all([got[k] == want[k] for k in HMC_FLAGS], axis=0)  # (T, C)
    return agree, np.cumprod(agree, axis=0).astype(bool)


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


def _assert_draw_stats_close(got, want, held):
    """The stats of the held chain-draws: energies within 1e-4 of their
    size, the energy change within 1e-4 of the energy's size, the accept
    statistic exp(min(0, dE)) within that relative, path lengths exact."""
    e_tol = 1e-4 * (1.0 + np.abs(want["energy"][held]))
    for k in ("energy", "model_logp"):
        np.testing.assert_allclose(got[k][held], want[k][held], atol=1e-4, rtol=1e-4)
    assert (np.abs(got["energy_error"] - want["energy_error"])[held] <= e_tol).all()
    err = np.abs(got["accept"] - want["accept"])[held]
    assert (err <= e_tol * want["accept"][held] + 1e-7).all(), err.max()
    np.testing.assert_array_equal(got["path_length"], want["path_length"])


@pytest.mark.parametrize("T,tuning", [(4, False), (8, True)], ids=["draw_chunk", "tune_chunk"])
def test_fused_hmc_plain_matches_jax_op(models, T, tuning):
    """(ii) the fused op chain for chain: a static draw chunk, and an
    adapt_dense tune chunk crossing a window swap, step size held."""
    jmodel, x, welford, got, want = _run_both(models, T, tuning, False, seed=5)
    agree, held = _held(got, want)
    assert agree.all(), agree
    assert got["n_steps"].max() >= 4 and 0 < got["accepted"].mean() < 1, got["accepted"].mean()
    sd = np.sqrt(jmodel.true_var)
    np.testing.assert_allclose(got["trace"] / sd, want["trace"] / sd, atol=1e-4, rtol=0)
    _assert_draw_stats_close(got, want, held)
    for k in ("step_size", "step_size_bar"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    for k in DA_KEYS + ("iter_count", "logp"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-4)
    if tuning:
        assert got["n_samples"] == want["n_samples"] == 3.0 + T
        assert got["prev_update"] == want["prev_update"] == 5.0
        assert got["window"] == want["window"] == 10.0
        port = _combined(got, welford, combine_dense_welford, torch.from_numpy)
        jax_ = _combined(want, welford, j_combine, jnp.asarray)
        fg, bg, _ = _replay_welford(welford, got["trace"].astype(np.float64))
        _assert_welford_close(port, jax_)
        _assert_welford_close(port, [fg, bg])


def test_fused_hmc_plain_tune_chunk_with_dual_averaging(models):
    """(ii) the tune chunk as the main path runs it, step size adapting:
    the chains held until their first disagreement with the JAX op, the
    dual-averaging state against the JAX package's update replayed over
    the chunk's own accept statistics, and the pooled Welford state against
    a float64 replay of the chunk's own trace."""
    jmodel, x, welford, got, want = _run_both(models, 8, True, True, seed=6)
    agree, held = _held(got, want)
    assert agree[0].all() and held[-1].mean() >= 0.75, agree
    # dual averaging turns each draw's rounding in the accept statistic into
    # the next draw's step size, so the first draw is held number for number
    first = np.zeros_like(held)
    first[0] = True
    sd = np.sqrt(jmodel.true_var)
    np.testing.assert_allclose(got["trace"][0] / sd, want["trace"][0] / sd, atol=1e-4, rtol=0)
    _assert_draw_stats_close(got, want, first)
    # its step sizes within 1e-5 relative plus what dual averaging makes of
    # the accept statistic's difference, sqrt(count) / (gamma (count + t0))
    cfg = JHMCConfig()
    cnt = x["da_count"]
    d_acc = np.abs(got["accept"][0] - want["accept"][0])
    lim = 1e-5 + np.sqrt(cnt) / (cfg.gamma * (cnt + cfg.t0)) * d_acc
    for k in ("step_size", "step_size_bar"):
        assert (np.abs(got[k][0] - want[k][0]) / want[k][0] <= lim).all(), k
    da = JDualAverage(*(jnp.asarray(x[k]) for k in DA_KEYS[:3]),
                      count=jnp.asarray(x["da_count"]).astype(jnp.int32),
                      mu=jnp.asarray(x["da_mu"]))
    for t in range(8):
        da = dual_average_update(da, jnp.asarray(got["accept"][t]), True,
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


# --------------------------------------------------------------------------
# (iii) sample() of both packages
# --------------------------------------------------------------------------

SN = 20


@pytest.fixture(scope="module", params=[("jitter+adapt_diag", 64, "per_draw_diag", None),
                                        ("jitter+adapt_full", 128, "fused_dense_pooled", None),
                                        ("jitter+adapt_full", 64, "per_draw_dense", False)],
                ids=["diag", "adapt_full", "adapt_full_per_chain"])
def slice_runs(request):
    """Both packages on the 20-d correlated Gaussian, each through its
    kernels (the JAX package's under interpret=True), one chain block; with
    per-chain dense adaptation (``cross_chain_adapt=False``) each on its
    tensor-op trajectory (the per-draw HMC kernels are diagonal-only)."""
    init, chains, engine, cross = request.param
    jmodel = jm.CorrelatedGaussian(SN)
    # a chain's own dense metric needs a longer tune than a pooled one
    kw = dict(model_ndim=SN, chains=chains, tune=300 if cross is None else 800, draws=300,
              random_seed=3, init=init, progressbar=False, return_final_state=True,
              cross_chain_adapt=cross)
    jstep = lmc.HamiltonianMC(model_ndim=SN, pallas_trajectory=_highest_spec(jmodel, SN),
                              pallas_interpret=True, chain_block=chains)
    jreport, treport = {}, {}
    jrun = lmc.sample(logp_dlogp_func=jmodel.logp_grad, step=jstep, perf_report=jreport, **kw)
    tmodel = tm.CorrelatedGaussian(SN, device="cpu")
    trun = lt.sample(tmodel.logp_grad, step=lt.HamiltonianMC(model_ndim=SN, chain_block=chains),
                     device="cpu", perf_report=treport, **kw)
    assert jreport["engine"] == treport["engine"] == engine
    return jmodel, jrun, trun


def test_hmc_sample_matches_jax(slice_runs):
    """(iii) posterior means and variances of the two runs within Monte
    Carlo error of each other (4.5 standard errors from each run's bulk
    ESS, over 20 dimensions), the accept rate and step counts within a few
    percent, the adapted step sizes within 5%."""
    from littlemcmc_torch.utils.diagnostics import ess_bulk

    model, (jtr, jst, jfs), (ttr, tst, tfs) = slice_runs
    jtr = np.asarray(jtr)
    sd = np.sqrt(model.true_var)
    ess = [np.array([ess_bulk(tr[:, :, i]) for i in range(SN)]) for tr in (jtr, ttr)]
    se_mean = sd * np.sqrt(1 / ess[0] + 1 / ess[1])
    z_mean = np.abs(jtr.mean((0, 1)) - ttr.mean((0, 1))) / se_mean
    var = [tr.reshape(-1, SN).var(0) for tr in (jtr, ttr)]
    z_var = np.abs(var[0] - var[1]) / (model.true_var * np.sqrt(2 / ess[0] + 2 / ess[1]))
    assert z_mean.max() < 4.5 and z_var.max() < 4.5, (z_mean.max(), z_var.max())
    for v in var:
        assert abs((v / model.true_var).mean() - 1) < 0.1
    assert abs(float(np.asarray(jst["accept"]).mean()) - tst["accept"].mean()) < 0.02
    n_j, n_t = float(np.asarray(jst["n_steps"]).mean()), tst["n_steps"].mean()
    assert abs(n_t / n_j - 1) < 0.05, (n_t, n_j)
    step_j = float(np.exp(np.asarray(jfs.da.log_bar)).mean())
    step_t = float(torch.exp(tfs.da.log_bar).mean())
    assert abs(np.log(step_t / step_j)) < np.log(1.05), (step_t, step_j)
    assert tst["diverging"].mean() < 0.01 and np.asarray(jst["diverging"]).mean() < 0.01


# --------------------------------------------------------------------------
# (iv) stats and the engine election
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw,engine,trajectory", [
    (dict(), "per_draw_diag", "plain"),
    (dict(init="adapt_full"), "fused_dense_pooled", "plain"),
    (dict(init="adapt_full", fuse_draws=False), "per_draw_dense_pooled", "tensor"),
    (dict(trajectory_spec=None), "per_draw_diag", "tensor"),
    (dict(fuse_draws=True), "fused_diag", "plain"),
    (dict(fuse_draws=True, trajectory_spec=None), None, None),
], ids=["diag_kernel", "fused_pooled", "dense_per_draw", "no_spec", "fused_diag",
        "fused_diag_raises"])
def test_hmc_engine_election_and_stats(kw, engine, trajectory):
    """(iv) the JAX package's engine choice for HMC, and the 11 stats with
    the names and dtypes of ``HamiltonianMC.stats_dtypes``; ``fuse_draws=
    True`` runs the fused kernel's diag branch and raises for a model
    without a kernel body."""
    model = tm.CorrelatedGaussian(3, device="cpu")
    step = lt.HamiltonianMC(model_ndim=3, chain_block=64,
                            **({"trajectory_spec": None} if "trajectory_spec" in kw else {}))
    kw = {k: v for k, v in kw.items() if k != "trajectory_spec"}
    args = dict(model_ndim=3, chains=128, tune=12, draws=4, random_seed=2, step=step,
                device="cpu", progressbar=False, compute_convergence_checks=False, **kw)
    if engine is None:
        with pytest.raises(ValueError, match="fuse_draws=True"):
            lt.sample(model.logp_grad, **args)
        return
    report = {}
    trace, stats = lt.sample(model.logp_grad, perf_report=report, **args)
    assert report["engine"] == engine and report["trajectory"] == trajectory
    assert report["kernel_launches"] == {"hmc_trajectory": 0, "fused_hmc": 0}
    assert trace.shape == (128, 4, 3) and np.isfinite(trace).all()
    dtypes = lmc.HamiltonianMC.stats_dtypes[0]
    assert lt.HamiltonianMC.stats_dtypes[0] == dtypes
    assert {k: v.dtype for k, v in stats.items()} == {k: np.dtype(v) for k, v in dtypes.items()}
    assert all(v.shape == (128, 4) for v in stats.values())
    assert (stats["n_steps"] >= 1).all() and not stats["tune"].any()
    np.testing.assert_allclose(stats["path_length"] / 2.0 >= 0, True)


@pytest.mark.parametrize("mean_accept", [0.8, 0.45], ids=["on_target", "low_accept"])
def test_warnings_from_hmc_stats(mean_accept):
    """(iv) HMC's stats have no tree depth and carry ``accept`` in place of
    ``mean_tree_accept``: the end-of-run warnings (acceptance interval,
    divergences, BFMI) are the JAX package's on the same stats."""
    from littlemcmc_tpu.report import warnings_from_stats as j_warnings
    from littlemcmc_torch.report import warnings_from_stats as t_warnings

    rng = np.random.default_rng(4)
    shape = (8, 200)
    stats = {"accept": np.clip(rng.normal(mean_accept, 0.1, shape), 0.0, 1.0),
             "diverging": rng.uniform(size=shape) < 0.002,
             "energy": rng.standard_normal(shape).cumsum(1),
             "n_steps": rng.integers(1, 9, shape), "step_size": np.full(shape, 0.3)}
    got = [(w.kind.name, w.level) for w in t_warnings(stats, target_accept=0.8)]
    want = [(w.kind.name, w.level) for w in j_warnings(stats, target_accept=0.8)]
    assert got == want
    assert ("BAD_ACCEPTANCE" in dict(got)) == (mean_accept < 0.7)
    assert "DIVERGENCES" in dict(got) and "TREEDEPTH" not in dict(got)


# --------------------------------------------------------------------------
# (v) the fused HMC kernel's register instances: their predicate, and the
# packed instance's segmented butterfly, proven in float32
# --------------------------------------------------------------------------

_CSRC = Path(__file__).resolve().parents[1] / "littlemcmc_torch" / "ops" / "csrc"


def _header_int(name: str, header: str = "hmc_transition.cuh") -> int:
    import re

    src = (_CSRC / header).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("chain_block", [1, 7, 8, 9, 16])
@pytest.mark.parametrize("n", [10, 100, 128, 129])
def test_fused_hmc_transition_matches_the_kernels(chain_block, n):
    """``fused_hmc_transition`` names the instance ``launch`` of
    ``csrc/fused_hmc.cu`` runs: the block one (body 1 dense, blocks of up
    to 8), the low-rank register one (body 4 low-rank, blocks of up to 8,
    n <= 32 kRegTrips), eight schools' packed one (any block), else the
    warp one; the bodies and metrics as ``hmc_register_body()`` and
    ``hmc_packed_body()`` name them."""
    import re

    from littlemcmc_torch.ops.nuts_trajectory import (BODY_IDS, HMC_REGISTER_MAX_N,
                                                      METRIC_IDS, fused_hmc_transition)

    src = (_CSRC / "hmc_transition.cuh").read_text()
    ids = {"kDiag": 0, "kDense": 1, "kLowRank": 2}
    pairs = {}
    for kind, fn in (("registers", "hmc_register_body"), ("packed", "hmc_packed_body")):
        body, metric = re.search(rf"constexpr bool {fn}\(\) \{{\s*return BODY == (\d+) && "
                                 r"METRIC == (k\w+);", src).groups()
        pairs[int(body), ids[metric]] = kind
    assert HMC_REGISTER_MAX_N == 32 * _header_int("kRegTrips")
    chains = _header_int("kBlockChains", "nuts_transition.cuh")
    for body, bid in BODY_IDS.items():
        for metric, mid in METRIC_IDS.items():
            want = pairs.get((bid, mid), "warp")
            if (body, metric) == ("correlated_gaussian", "dense") and chain_block <= chains:
                want = "block"
            if want == "registers" and (chain_block > chains or n > HMC_REGISTER_MAX_N):
                want = "warp"
            assert fused_hmc_transition(body, metric, chain_block, n) == want, (body, metric)


def _warp_sum32(x):
    """``warp_sum`` of ``csrc/nuts_transition.cuh`` in float32 over a warp
    whose lanes 0..9 hold ``x`` and the rest +0: every lane's result."""
    v = np.zeros(32, np.float32)
    v[:10] = x
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[lanes ^ o]
    return v


def _segment_sum(x, L):
    """``segment_sums<L>`` of ``csrc/hmc_transition.cuh`` in float32 on one
    segment whose lanes 0..9 hold ``x``: its lanes' results."""
    zero = np.float32(0.0)
    if L == 16:
        v = np.zeros(16, np.float32)
        v[:10] = x
        v = v + zero
        lanes = np.arange(16)
        for o in (8, 4, 2, 1):
            v = v + v[lanes ^ o]
        return v[:10]
    v = np.asarray(x, np.float32) + zero
    i = np.arange(10)
    j = i ^ 8
    v = v + np.where(j < 10, v[np.where(j < 10, j, i)], zero)
    for o in (4, 2, 1):
        j = i ^ o
        v = v + v[np.where(j < 10, j, j - 8)]
    return v


def _same_bits(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return (a.view(np.uint32) == b.view(np.uint32)) | (np.isnan(a) & np.isnan(b))


def _check_segments(x):
    with np.errstate(over="ignore", invalid="ignore"):
        ref = _warp_sum32(x)
        assert _same_bits(ref, ref[0]).all()  # the butterfly leaves every lane alike
        for L in (16, 10):
            got = _segment_sum(x, L)
            assert _same_bits(got, ref[0]).all(), (L, x, got, ref[0])


_SPECIAL = np.array([0.0, -0.0, 1e-45, -1e-45, 1.17549435e-38, -3e-39, np.inf, -np.inf,
                     3.4e38, -3.4e38, 1.0, -1.0, 1e-8], np.float32)


def test_segment_sums_shipped_form_is_one_of_the_proven_ones():
    """The packed instance's segment (``kEsHmcLanes``) is one of the two
    forms proven below, and matches its chains a warp."""
    cpw = _header_int("kEsHmcChainsPerWarp")
    assert cpw in (2, 3)
    src = (_CSRC / "hmc_transition.cuh").read_text()
    assert "constexpr int kEsHmcLanes = kEsHmcChainsPerWarp == 2 ? 16 : 10;" in src


@pytest.mark.parametrize("pattern", range(6))
def test_segment_sums_keep_signed_zeros_subnormals_and_infinities(pattern):
    """Every lane of a segment gets warp_sum's bits on columns of signed
    zeros (all -0: the first round's + 0 makes +0), subnormals, infinities
    of both signs (inf - inf: NaN) and values near overflow."""
    rng = np.random.default_rng(pattern)
    cases = [np.full(10, -0.0, np.float32), np.full(10, 1e-45, np.float32),
             rng.choice(_SPECIAL, 10), rng.choice(_SPECIAL[:6], 10),
             np.array([np.inf] + [-0.0] * 9, np.float32),
             np.array([3.4e38] * 5 + [-3.4e38] * 5, np.float32)]
    _check_segments(cases[pattern])


@settings(max_examples=400, deadline=None)
@given(st.lists(st.one_of(st.floats(width=32), st.sampled_from([float(v) for v in _SPECIAL])),
                min_size=10, max_size=10))
def test_segment_sums_give_warp_sums_bits(xs):
    """Both segment forms of the packed instance's butterfly (16 lanes; 10
    lanes reading a virtual lane j >= 10 from lane j - 8) give every lane
    of the segment the bits of warp_sum over 32 lanes with zeros above
    lane 9, on any float32 columns (NaN payloads aside)."""
    _check_segments(np.array(xs, np.float32))
