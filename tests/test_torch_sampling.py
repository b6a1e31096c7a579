"""The port's first slice as a whole: ``sample()`` against the JAX package.

Both packages sample the 20-d correlated Gaussian with NUTS, jittered
starts, per-chain diagonal adaptation and dual averaging: the port with
``device="cpu"`` (the plain trajectory), the JAX package through its
trajectory kernel under ``interpret=True`` on the per-draw engine. Their
momenta come from different generators, so the runs are compared
statistically: posterior moments within Monte Carlo error of the truth and
of each other, sampler stats within 10-15% of each other.
"""

import ast
import os
import subprocess
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
from littlemcmc_tpu.ops import PallasModelSpec
from littlemcmc_tpu.ops.nuts_trajectory_pallas import padded_dim
from littlemcmc_torch.models import CorrelatedGaussian, StandardNormal
from littlemcmc_torch.utils.diagnostics import ess_bulk

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N, CHAINS, TUNE, DRAWS = 20, 64, 200, 300


@pytest.fixture(scope="module")
def torch_run():
    model = CorrelatedGaussian(N, device="cpu")
    report = {}
    trace, stats = lt.sample(model.logp_grad, model_ndim=N, chains=CHAINS, tune=TUNE,
                             draws=DRAWS, random_seed=1, device="cpu",
                             chain_block=CHAINS, perf_report=report, progressbar=False)
    return model, trace, stats, report


@pytest.fixture(scope="module")
def jax_run():
    model = jm.CorrelatedGaussian(N)
    prec = np.zeros((padded_dim(N),) * 2, np.float32)
    prec[:N, :N] = model.prec.astype(np.float32)

    def fn(q, p):
        g = -jnp.dot(q, p, precision="highest", preferred_element_type=jnp.float32)
        return 0.5 * jnp.sum(q * g, axis=1, keepdims=True), g

    step = lmc.NUTS(model_ndim=N, pallas_trajectory=PallasModelSpec(fn, (jnp.asarray(prec),), N),
                    pallas_interpret=True)
    trace, stats = lmc.sample(logp_dlogp_func=model.logp_grad, model_ndim=N,
                              chains=CHAINS, tune=TUNE, draws=DRAWS, random_seed=1,
                              step=step, fuse_draws=False, progressbar=False)
    return np.asarray(trace), {k: np.asarray(v) for k, v in stats.items()}


def _moments(trace, true_var):
    """Per-dimension mean in posterior sds, its Monte Carlo sd, and the
    variance over the true variance."""
    ess = np.array([ess_bulk(trace[:, :, i]) for i in range(trace.shape[2])])
    flat = trace.reshape(-1, trace.shape[2])
    sd = np.sqrt(true_var)
    return flat.mean(0) / sd, 1.0 / np.sqrt(ess), flat.var(0) / true_var, ess


def test_posterior_moments_within_mc_error(torch_run, jax_run):
    model, t_trace, _, _ = torch_run
    j_trace, _ = jax_run
    assert t_trace.shape == j_trace.shape == (CHAINS, DRAWS, N)
    t_mean, t_mcse, t_var, t_ess = _moments(t_trace, model.true_var)
    j_mean, j_mcse, j_var, j_ess = _moments(j_trace, model.true_var)
    assert t_ess.min() > 1000 and j_ess.min() > 1000
    # each mean within 4.5 Monte Carlo sds of the truth and of the other run
    assert np.all(np.abs(t_mean) < 4.5 * t_mcse)
    assert np.all(np.abs(t_mean - j_mean) < 4.5 * np.hypot(t_mcse, j_mcse))
    # variance ratios: the average over dims has MC sd ~ sqrt(2/ESS)/sqrt(N)
    assert abs(t_var.mean() - 1.0) < 0.05
    assert abs(t_var.mean() - j_var.mean()) < 0.05


def test_sampler_stats_agree(torch_run, jax_run):
    _, _, ts, _ = torch_run
    _, js = jax_run
    np.testing.assert_allclose(ts["mean_tree_accept"].mean(), js["mean_tree_accept"].mean(),
                               rtol=0.10)
    np.testing.assert_allclose(ts["depth"].mean(), js["depth"].mean(), rtol=0.10)
    np.testing.assert_allclose(ts["tree_size"].mean(), js["tree_size"].mean(), rtol=0.15)
    np.testing.assert_allclose(ts["step_size"][:, -1].mean(), js["step_size"][:, -1].mean(),
                               rtol=0.15)
    assert ts["diverging"].mean() < 0.01 and js["diverging"].mean() < 0.01


def test_stats_keys_and_dtypes_match(torch_run, jax_run):
    _, _, ts, report = torch_run
    _, js = jax_run
    assert list(ts) == list(js)
    for k in js:
        assert ts[k].dtype == js[k].dtype, k
        assert ts[k].shape == (CHAINS, DRAWS), k
    assert not ts["tune"].any()
    assert report["engine"] == "per_draw_diag" and report["trajectory"] == "plain"
    assert report["kernel_launches"] == {"nuts_trajectory": 0, "fused_nuts": 0}
    assert report["chain_block"] == CHAINS
    assert report["sample_seconds"] > 0


def test_sample_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        lt.sample(StandardNormal(3, device="cpu").logp_grad, model_ndim=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        StandardNormal(3)
    with pytest.raises(RuntimeError, match="CUDA"):
        lt.init_nuts(model_ndim=3)


def test_sample_small_standard_normal_with_init_nuts():
    model = StandardNormal(3, device="cpu")
    start, step = lt.init_nuts(model.logp_grad, model_ndim=3, random_seed=3,
                               device="cpu", chain_block=8)
    assert start.shape == (3,) and bool((start.abs() <= 1).all())
    trace, stats, state = lt.sample(model.logp_grad, model_ndim=3, chains=8, tune=60,
                                    draws=40, step=step, random_seed=3, device="cpu",
                                    discard_tuned_samples=False, return_final_state=True,
                                    progressbar=False)
    assert trace.shape == (8, 100, 3)
    assert stats["tune"][:, :60].all() and not stats["tune"][:, 60:].any()
    assert state.q.shape == (8, 3) and int(state.iter_count[0]) == 100
    assert isinstance(step.warnings(), list)


def test_sample_rejects_what_the_slice_does_not_run():
    def nan_model(q):
        return q.sum() * float("nan"), q

    def plain_model(q):
        return -0.5 * (q * q).sum(), -q

    with pytest.raises(ValueError, match="Bad initial energy"):
        lt.sample(nan_model, model_ndim=2, device="cpu", progressbar=False)
    with pytest.raises(NotImplementedError, match="callback"):
        lt.sample(plain_model, model_ndim=2, device="cpu", progressbar=False,
                  callback=print)
    with pytest.raises(ValueError, match="Unknown initializer"):
        lt.sample(plain_model, model_ndim=2, init="adapt_lowrank", device="cpu")


def _port_files():
    return sorted((ROOT / "littlemcmc_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_never_imports_jax_or_the_jax_package():
    banned = ("jax", "flax", "littlemcmc_tpu")
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: imports {name}"
    # and importing every module works with those packages blocked
    modules = [".".join(p.relative_to(ROOT).with_suffix("").parts) for p in _port_files()]
    modules = [m.removesuffix(".__init__") for m in modules]
    code = ("import sys\n"
            + "".join(f"sys.modules[{b!r}] = None\n" for b in banned)
            + "import importlib\n"
            + "".join(f"importlib.import_module({m!r})\n" for m in modules))
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
