"""``dtype=torch.float64``: the port's deterministic modules against JAX's
under ``jax_enable_x64``, and ``sample()`` end to end.

JAX's x64 mode is a process-wide flag, so the JAX side runs in a
subprocess, as ``tests/test_float64.py`` runs it: it takes the inputs this
test makes with numpy from a seed and writes its results to a file. Both
sides compute in float64 and agree to 1e-12: ``log1mexp`` and
``logdiffexp``, the leapfrog (two schemes, a dense quadratic model, a
diagonal metric), dual averaging, both Welford accumulators and the dense
metric's update through two window swaps. ``sample(dtype=torch.float64)``
then mirrors ``tests/test_float64.py:18-106``: the state, metric and trace
are float64 (not cast afterwards), the stats keep the reference's dtypes,
the moments are right, the chunked runner works, and the kernels, which
are float32-only, are declined: the election runs the tensor ops, and
``fuse_draws=True`` raises.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import littlemcmc_torch as lt
from littlemcmc_torch import quadpotential as t_qp
from littlemcmc_torch.integration import compute_state, leapfrog
from littlemcmc_torch.math import log1mexp, logdiffexp
from littlemcmc_torch.models import CorrelatedGaussian
from littlemcmc_torch.step_sizes import dual_average_init, dual_average_update

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-12
C, N, STEPS = 3, 5, 30
DA = dict(target=0.8, gamma=0.05, k=0.75, t0=10.0)


def _inputs():
    rng = np.random.default_rng(64)
    B = rng.standard_normal((N, N))
    return dict(
        x=np.concatenate([rng.uniform(1e-6, 0.6, 20), rng.uniform(0.7, 30.0, 20)]),
        a=rng.uniform(1.0, 3.0, 8), b=rng.uniform(-2.0, 0.9, 8),
        prec=B @ B.T / N + np.eye(N),
        q=rng.standard_normal((C, N)), p=rng.standard_normal((C, N)),
        var=rng.uniform(0.5, 2.0, N),
        accept=rng.uniform(0.3, 1.0, STEPS),
        xs=rng.standard_normal((STEPS, C, N)) @ B.T + 0.3,
        mean0=rng.standard_normal((C, N)))


_X64_WORKER = r"""
import os, sys
os.environ.pop("JAX_PLATFORMS", None)
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, {repo!r})
import jax.numpy as jnp
import numpy as np
from littlemcmc_tpu.integration import compute_state, leapfrog
from littlemcmc_tpu.math import log1mexp, logdiffexp
from littlemcmc_tpu import quadpotential as qp
from littlemcmc_tpu.step_sizes import dual_average_init, dual_average_update

f64 = jnp.float64
d = dict(np.load({inp!r}))
out = {{}}
out["log1mexp"] = log1mexp(jnp.asarray(d["x"]))
out["logdiffexp"] = logdiffexp(jnp.asarray(d["a"]), jnp.asarray(d["b"]))
prec = jnp.asarray(d["prec"])

def logp_grad(q):
    g = -prec @ q
    return 0.5 * jnp.dot(q, g), g

pot = qp.QuadPotentialDiag.create(jnp.asarray(d["var"]), f64)
for scheme in ("leapfrog", "two_stage"):
    def run(q, p, scheme=scheme):
        s = compute_state(pot, logp_grad, q, p)
        for _ in range(10):
            s = leapfrog(pot, logp_grad, jnp.asarray(0.1, f64), s, scheme)
        return s.q, s.p, s.energy
    out[scheme + "/q"], out[scheme + "/p"], out[scheme + "/energy"] = jax.jit(jax.vmap(run))(
        jnp.asarray(d["q"]), jnp.asarray(d["p"]))
da = dual_average_init(0.3, f64)
da_step = jax.jit(lambda da, a: dual_average_update(da, a, True, target=0.8, gamma=0.05,
                                                    k=0.75, t0=10.0))
for a in d["accept"]:
    da = da_step(da, jnp.asarray(a))
out["da"] = [da.log_step, da.log_bar, da.hbar, da.mu]
wv = jax.vmap(lambda m: qp.WelfordVariance.create(m.shape[0], m, jnp.ones_like(m), 2.0, f64))(
    jnp.asarray(d["mean0"]))
wc = jax.vmap(lambda m: qp.WelfordCovariance.create(m.shape[0], m, 2.0 * jnp.eye(m.shape[0]),
                                                    3.0, f64))(jnp.asarray(d["mean0"]))
full = jax.vmap(lambda m: qp.QuadPotentialFullAdapt.create(
    m.shape[0], initial_mean=m, initial_cov=jnp.eye(m.shape[0], dtype=f64), initial_weight=10.0,
    adaptation_window=7, dtype=f64))(jnp.asarray(d["xs"][0]))
step = jax.jit(lambda wv, wc, full, x: (jax.vmap(lambda w, y: w.add_sample(y))(wv, x),
                                        jax.vmap(lambda w, y: w.add_sample(y))(wc, x),
                                        jax.vmap(lambda p, y: p.update(y, y, True))(full, x)))
for x in d["xs"]:
    wv, wc, full = step(wv, wc, full, jnp.asarray(x))
out.update({{"wv/" + k: getattr(wv, k) for k in ("w_sum", "mean", "raw_var")}})
out.update({{"wc/" + k: getattr(wc, k) for k in ("n_samples", "mean", "raw_cov")}})
out.update({{"full/" + k: getattr(full, k) for k in ("cov", "chol")}})
out.update({{"full/fg." + k: getattr(full.fg, k) for k in ("mean", "raw_cov")}})
out["full/bg.raw_cov"] = full.bg.raw_cov
assert all(np.asarray(v).dtype == np.float64 for v in jax.tree.leaves(out))
np.savez({out_file!r}, **{{k: np.asarray(jnp.stack(v) if isinstance(v, list) else v)
                          for k, v in out.items()}})
print("x64 OK")
"""


def _port(d):
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    out = {"log1mexp": log1mexp(t["x"]), "logdiffexp": logdiffexp(t["a"], t["b"])}
    prec = t["prec"]

    def logp_grad(q):
        g = -q @ prec
        return 0.5 * (q * g).sum(-1), g

    pot = t_qp.QuadPotentialDiag.create(t["var"]).broadcast(C)
    for scheme in ("leapfrog", "two_stage"):
        s = compute_state(pot, logp_grad, t["q"], t["p"])
        for _ in range(10):
            s = leapfrog(pot, logp_grad, torch.full((C,), 0.1, dtype=torch.float64), s, scheme)
        out[scheme + "/q"], out[scheme + "/p"], out[scheme + "/energy"] = s.q, s.p, s.energy
    da = dual_average_init(0.3, 1, dtype=torch.float64)
    for a in t["accept"]:
        da = dual_average_update(da, a.reshape(1), True, **DA)
    out["da"] = torch.stack([da.log_step[0], da.log_bar[0], da.hbar[0], da.mu[0]])
    wv = t_qp.WelfordVariance.create(t["mean0"], torch.ones_like(t["mean0"]), 2.0)
    wc = t_qp.WelfordCovariance.create(t["mean0"], 2.0 * torch.eye(N, dtype=torch.float64),
                                       3.0)
    full = t_qp.QuadPotentialFullAdapt.create(t["xs"][0], torch.eye(N, dtype=torch.float64),
                                              initial_weight=10.0, adaptation_window=7)
    for x in t["xs"]:
        wv, wc, full = wv.add_sample(x), wc.add_sample(x), full.update(x, None, True)
    out.update({"wv/" + k: getattr(wv, k) for k in ("w_sum", "mean", "raw_var")})
    out.update({"wc/" + k: getattr(wc, k) for k in ("n_samples", "mean", "raw_cov")})
    out.update({"full/" + k: getattr(full, k) for k in ("cov", "chol")})
    out.update({"full/fg." + k: getattr(full.fg, k) for k in ("mean", "raw_cov")})
    out["full/bg.raw_cov"] = full.bg.raw_cov
    return out


def test_deterministic_modules_match_jax_x64(tmp_path):
    d = _inputs()
    np.savez(tmp_path / "inputs.npz", **d)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _X64_WORKER.format(repo=REPO, inp=str(tmp_path / "inputs.npz"),
                                                  out_file=str(tmp_path / "jax.npz"))],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert proc.returncode == 0 and "x64 OK" in proc.stdout, (proc.stdout, proc.stderr)
    want = dict(np.load(tmp_path / "jax.npz"))
    got = _port(d)
    for k, w in want.items():
        g = got[k]
        g = torch.stack(g) if isinstance(g, list) else g
        assert g.dtype == torch.float64, k
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL, err_msg=k)
    assert tuple(got["full/cov"].shape) == (C, N, N) and len(want) == len(got)


def _logp_grad(q):
    return -0.5 * (q * q).sum(), -q


def test_sample_float64_end_to_end():
    """``tests/test_float64.py:18-55``: the run itself is float64."""
    trace, stats, final = lt.sample(
        _logp_grad, model_ndim=3, chains=8, tune=400, draws=600, random_seed=5,
        progressbar=False, device="cpu", dtype=torch.float64, return_final_state=True)
    assert final.q.dtype == torch.float64 and final.potential.var.dtype == torch.float64
    assert final.da.log_step.dtype == torch.float64
    assert trace.dtype == np.float64 and trace.shape == (8, 600, 3)
    for name, dt in lt.NUTS.stats_dtypes[0].items():
        assert stats[name].dtype == np.dtype(dt), (name, stats[name].dtype)
    draws = trace.reshape(-1, 3)
    assert np.abs(draws.mean(0)).max() < 0.1, draws.mean(0)
    assert np.abs(draws.var(0) - 1.0).max() < 0.15, draws.var(0)


def test_sample_float64_chunked():
    """``tests/test_float64.py:58-106``: the chunked runner in float64."""
    trace, _ = lt.sample(_logp_grad, model_ndim=3, chains=8, tune=100, draws=100,
                         random_seed=5, progressbar=False, device="cpu", dtype=torch.float64,
                         progress_every=50, compute_convergence_checks=False)
    assert trace.dtype == np.float64 and trace.shape == (8, 100, 3)


@pytest.mark.parametrize("init", ["jitter+adapt_diag", "jitter+adapt_full"])
def test_float64_declines_the_kernels(init):
    """A model with a kernel body (and a batched model kernel, row 5) runs
    the tensor ops in float64: no kernel, float64 out; the same call in
    float32 elects a kernel engine."""
    m = CorrelatedGaussian(6, device="cpu", use_kernel=True)
    kw = dict(model_ndim=6, chains=128, tune=30, draws=30, random_seed=2, device="cpu",
              progressbar=False, compute_convergence_checks=False, init=init,
              return_final_state=True)
    rep = {}
    trace, _, final = lt.sample(m.logp_grad, dtype=torch.float64, perf_report=rep,
                                fuse_draws=False, **kw)
    assert rep["trajectory"] == "tensor" and trace.dtype == np.float64
    assert rep["engine"] == ("per_draw_dense_pooled" if init.endswith("full")
                             else "per_draw_diag")
    assert final.q.dtype == torch.float64
    rep32 = {}
    lt.sample(m.logp_grad, perf_report=rep32, fuse_draws=False,
              **dict(kw, tune=2, draws=2))
    assert rep32["trajectory"] == "plain"


def test_fuse_draws_with_float64_raises():
    m = CorrelatedGaussian(6, device="cpu")
    with pytest.raises(ValueError, match="float32 only"):
        lt.sample(m.logp_grad, model_ndim=6, chains=16, tune=5, draws=5, device="cpu",
                  progressbar=False, dtype=torch.float64, fuse_draws=True)
    with pytest.raises(ValueError, match="float32 only"):
        lt.sample(m.logp_grad, model_ndim=6, chains=16, tune=5, draws=5, device="cpu",
                  progressbar=False, dtype=torch.float64,
                  step=lt.NUTS(model_ndim=6, trajectory_spec=m.trajectory_spec()))
    with pytest.raises(ValueError, match="dtype must be"):
        lt.sample(m.logp_grad, model_ndim=6, chains=16, tune=5, draws=5, device="cpu",
                  progressbar=False, dtype=torch.float16)
