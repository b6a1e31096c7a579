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
    calls = []
    lt.sample(plain_model, model_ndim=2, chains=2, tune=5, draws=5, device="cpu",
              progressbar=False, callback=lambda **kw: calls.append(kw["iteration"]))
    assert calls == [5, 10]
    with pytest.raises(ValueError, match="Unknown initializer"):
        lt.sample(plain_model, model_ndim=2, init="advi", device="cpu")


_UNPORTED = {"model_axis": ("model", 18)}


def _plain_model(q):
    return -0.5 * (q * q).sum(), -q


@pytest.mark.parametrize("with_step", [False, True], ids=["no_step", "step"])
@pytest.mark.parametrize("name", sorted(_UNPORTED))
def test_sample_raises_for_each_jax_argument_it_does_not_run(name, with_step, tmp_path):
    """JAX's ``sample()`` names an argument that the port does not run yet
    (``model_axis``, ``littlemcmc_tpu/sampling.py:899``): the port names it
    too, and a value other than JAX's default raises, whether or not
    ``step`` is given, citing the ROADMAP Queue 1 item that ports it."""
    value, item = _UNPORTED[name]
    kw = dict(step=lt.NUTS(model_ndim=2)) if with_step else {}
    with pytest.raises(NotImplementedError, match=rf"`{name}` is ROADMAP Queue 1 item {item}\."):
        lt.sample(_plain_model, model_ndim=2, chains=2, tune=5, draws=5, device="cpu",
                  progressbar=False, compute_convergence_checks=False, **kw, **{name: value})
    assert not (tmp_path / "checkpoints").exists()


def test_sample_runs_with_the_jax_defaults_of_those_arguments():
    trace, _ = lt.sample(_plain_model, model_ndim=2, chains=2, tune=5, draws=5, device="cpu",
                         progressbar=False, compute_convergence_checks=False, mesh=None,
                         chain_axis="chains", model_axis=None, dtype=torch.float32,
                         progress_every=None, checkpoint_dir=None, checkpoint_every=None,
                         resume=False)
    assert tuple(trace.shape) == (2, 5, 2) and str(trace.dtype).endswith("float32")


def test_warnings_leave_out_the_kept_tuning_draws():
    """``step.warnings()`` after ``discard_tuned_samples=False`` leaves the
    kept tuning draws out, as the JAX package's ``step._last_tune`` does
    (``littlemcmc_tpu/sampling.py:106-113``, ``:1555``): StandardNormal(2),
    8 chains, 50 + 50, seed 1, where every tuning column of both runs is
    marked divergent. Both packages give the same warning kinds."""
    kinds = {}
    for name, pkg, model in (("jax", lmc, jm.StandardNormal(2)),
                             ("torch", lt, StandardNormal(2, device="cpu"))):
        step = pkg.NUTS(model_ndim=2)
        kw = {"device": "cpu"} if name == "torch" else {}
        trace, stats = pkg.sample(model.logp_grad, model_ndim=2, chains=8, tune=50, draws=50,
                                  step=step, random_seed=1, discard_tuned_samples=False,
                                  progressbar=False, **kw)
        assert np.asarray(stats["diverging"]).shape == (8, 100)
        kinds[name] = sorted(w.kind.name for w in step.warnings())
        # an explicit tune=0 still counts every column
        assert "DIVERGENCES" in {w.kind.name for w in step.warnings(tune=0)}
    assert kinds["torch"] == kinds["jax"] and "DIVERGENCES" not in kinds["torch"], kinds


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


# --------------------------------------------------------------------------
# The rest of the sample() surface: progress, seeds, step_rand, exports
# --------------------------------------------------------------------------

_BASE = dict(device="cpu", progressbar=False, compute_convergence_checks=False)


def test_live_progress_at_25_draw_granularity(caplog):
    """``progress_every=25`` with ``progressbar`` logs a line at most every
    25 draws with the divergences so far (the JAX package's live progress,
    ``tests/test_sampling.py:373-389``, which the JAX package gives by
    default from inside its scan; the port's default reads nothing between
    its chunks)."""
    import logging
    import re

    with caplog.at_level(logging.INFO, logger="littlemcmc_torch"):
        lt.sample(_plain_model, model_ndim=1, draws=60, tune=40, chains=4, random_seed=0,
                  device="cpu", progressbar=True, progress_every=25)
    lines = [r.message for r in caplog.records
             if "iterations" in r.message and "divergences" in r.message]
    assert len(lines) >= 3  # 100 total iterations / 25
    assert any("tuning" in ln for ln in lines)
    assert any("sampling" in ln for ln in lines)
    done = [int(re.match(r"\s*(\d+)/", ln).group(1)) for ln in lines]
    assert all(b - a <= 25 for a, b in zip(done, done[1:]))


class _Unread:
    """A divergence count that fails when the host reads it."""

    def __add__(self, other):
        return self

    __radd__ = __add__

    def __int__(self):
        raise AssertionError("the host read the divergence count")


def test_default_chunk_loop_reads_nothing_between_chunks():
    """Without progress_every, a callback or checkpoints the chunk loop
    never reads the divergence count (no host synchronisation a chunk); a
    callback reads it after every chunk."""
    from littlemcmc_torch.sampling import _run_chunked

    def factory(chunk, tuning, collect):
        return lambda state, iter0: (state, None, _Unread())

    state, outs, ndiv = _run_chunked(factory, "s", 300, 700, collect_tune=False)
    assert state == "s" and outs == [None] * 3 and isinstance(ndiv, _Unread)
    with pytest.raises(AssertionError, match="host read"):
        _run_chunked(factory, "s", 300, 700, collect_tune=False, callback=lambda **kw: None)


@pytest.mark.parametrize("method", ["nuts", "hmc"])
def test_per_chain_seed_list(method):
    """A seed list gives each chain its own stream on the tensor-op paths
    (``tests/test_sampling.py:158-178``): chains sharing a seed are
    bit-identical, chains with different seeds differ, and a chain's trace
    depends on its own seed alone, not its slot or neighbours."""
    def step():
        return None if method == "nuts" else lt.HamiltonianMC(model_ndim=2)

    kw = dict(model_ndim=2, draws=40, tune=40, **_BASE)
    rep = {}
    trace, _ = lt.sample(_plain_model, chains=4, random_seed=[7, 8, 7, 9], step=step(),
                         perf_report=rep, **kw)
    assert rep["trajectory"] == "tensor"
    np.testing.assert_array_equal(trace[0], trace[2])
    assert not np.allclose(trace[0], trace[1])
    assert not np.allclose(trace[1], trace[3])
    trace2, _ = lt.sample(_plain_model, chains=2, random_seed=[8, 11], step=step(), **kw)
    np.testing.assert_array_equal(trace2[0], trace[1])
    assert abs(trace.mean()) < 0.5 and abs(trace.std() - 1.0) < 0.3


@pytest.mark.parametrize("fuse_draws", [None, True])
def test_seed_list_on_the_kernel_paths(fuse_draws):
    """On the kernel paths a seed list seeds each chain's start and momenta
    (per draw) from its own stream and the kernels' words from chain 0's
    seed, as the JAX kernels' are: the run is reproducible, and a list
    gives other draws than its first seed alone."""
    m = CorrelatedGaussian(4, device="cpu")
    kw = dict(model_ndim=4, chains=8, draws=30, tune=30, fuse_draws=fuse_draws, **_BASE)
    rep = {}
    a, _ = lt.sample(m.logp_grad, random_seed=list(range(3, 11)), perf_report=rep, **kw)
    b, _ = lt.sample(m.logp_grad, random_seed=list(range(3, 11)), **kw)
    c, _ = lt.sample(m.logp_grad, random_seed=3, **kw)
    assert rep["trajectory"] == "plain"
    assert rep["engine"] == ("fused_diag" if fuse_draws else "per_draw_diag")
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, c) and np.isfinite(a).all()


def test_seed_list_wrong_length_raises():
    with pytest.raises(ValueError, match="one seed per chain"):
        lt.sample(_plain_model, model_ndim=2, draws=4, tune=4, chains=4, random_seed=[1, 2],
                  **_BASE)


@pytest.mark.parametrize("engine", ["tree", "kernel"])
def test_zero_d_array_seed_is_master_seed(engine):
    """``random_seed=np.array(42)`` (0-d) is ``random_seed=42``
    (``tests/test_sampling.py:392-402``)."""
    if engine == "tree":
        kw = dict(logp_dlogp_func=_plain_model, model_ndim=1)
    else:
        kw = dict(logp_dlogp_func=StandardNormal(3, device="cpu").logp_grad, model_ndim=3)
    t_scalar, _ = lt.sample(random_seed=42, draws=20, tune=20, chains=4, **kw, **_BASE)
    t_0d, _ = lt.sample(random_seed=np.array(42), draws=20, tune=20, chains=4, **kw, **_BASE)
    np.testing.assert_array_equal(t_scalar, t_0d)


def test_init_nuts_takes_the_first_seed_of_a_list():
    a, _ = lt.init_nuts(_plain_model, model_ndim=3, random_seed=[5, 6, 7], device="cpu")
    b, _ = lt.init_nuts(_plain_model, model_ndim=3, random_seed=5, device="cpu")
    assert torch.equal(a, b)


def _step_cases():
    m = CorrelatedGaussian(4, device="cpu")
    return {"tree": (_plain_model, 2, lt.NUTS),
            "kernel": (m.logp_grad, 4, lt.NUTS),
            "hmc_kernel": (m.logp_grad, 4, lt.HamiltonianMC),
            "hmc_tensor": (_plain_model, 2, lt.HamiltonianMC)}


@pytest.mark.parametrize("engine", ["tree", "kernel", "hmc_kernel", "hmc_tensor"])
def test_step_rand_identity_keeps_the_bits(engine):
    fn, n, cls = _step_cases()[engine]
    kw = dict(model_ndim=n, chains=8, draws=30, tune=30, random_seed=3, **_BASE)
    calls = []

    def identity(step_size, generator):
        assert step_size.shape == (8,) and isinstance(generator, torch.Generator)
        calls.append(1)
        return step_size

    a, sa = lt.sample(fn, step=cls(model_ndim=n), **kw)
    b, sb = lt.sample(fn, step=cls(model_ndim=n, step_rand=identity), **kw)
    assert len(calls) == 60
    np.testing.assert_array_equal(a, b)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k])


def test_step_rand_jitter_agrees_with_jax():
    """A +-10% step-size jitter: the port's draws (the kernel's plain
    version) and the JAX package's (its tree) agree on the 6-d correlated
    Gaussian's moments within Monte Carlo error."""
    def t_jitter(step_size, generator):
        u = torch.rand(step_size.shape, generator=generator, device=step_size.device)
        return step_size * (0.9 + 0.2 * u)

    def j_jitter(step_size, key):
        return step_size * jax.random.uniform(key, minval=0.9, maxval=1.1)

    n = 6
    tmodel, jmodel = CorrelatedGaussian(n, device="cpu"), jm.CorrelatedGaussian(n)
    kw = dict(model_ndim=n, chains=16, tune=150, draws=200, random_seed=2, progressbar=False)
    rep = {}
    t_trace, t_stats = lt.sample(tmodel.logp_grad, device="cpu", perf_report=rep,
                                 step=lt.NUTS(model_ndim=n, step_rand=t_jitter), **kw)
    assert rep["engine"] == "per_draw_diag" and rep["trajectory"] == "plain"
    j_trace, j_stats = lmc.sample(jmodel.logp_grad, step=lmc.NUTS(model_ndim=n,
                                                                  step_rand=j_jitter), **kw)
    t_mean, t_mcse, t_var, _ = _moments(t_trace, tmodel.true_var)
    j_mean, j_mcse, j_var, _ = _moments(np.asarray(j_trace), tmodel.true_var)
    assert np.all(np.abs(t_mean) < 4.5 * t_mcse)
    assert np.all(np.abs(t_mean - j_mean) < 4.5 * np.hypot(t_mcse, j_mcse))
    assert abs(t_var.mean() - 1.0) < 0.1 and abs(t_var.mean() - j_var.mean()) < 0.1
    np.testing.assert_allclose(t_stats["depth"].mean(), np.asarray(j_stats["depth"]).mean(),
                               rtol=0.15)


def test_step_rand_runs_per_draw():
    """With a step_rand hook ``fuse_draws=None`` elects the per-draw engine
    and ``fuse_draws=True`` raises (``littlemcmc_tpu/sampling.py:1241,
    1338``)."""
    model = StandardNormal(2, device="cpu")
    step = lt.NUTS(model_ndim=2, step_rand=lambda s, g: s)
    kw = dict(model_ndim=2, chains=16, tune=5, draws=5, **_BASE)
    rep = {}
    lt.sample(model.logp_grad, step=step, perf_report=rep, **kw)
    assert rep["engine"] == "per_draw_diag"
    rep = {}
    lt.sample(model.logp_grad, perf_report=rep, **kw)
    assert rep["engine"] == "fused_diag"  # the same call without the hook
    with pytest.raises(ValueError, match="step_rand"):
        lt.sample(model.logp_grad, step=step, fuse_draws=True, **kw)


def test_perf_report_has_transfer_seconds():
    rep = {}
    lt.sample(_plain_model, model_ndim=2, chains=2, tune=5, draws=5, perf_report=rep, **_BASE)
    assert rep["transfer_seconds"] >= 0 and rep["chunk"] == 250


def test_public_names_match_the_jax_package():
    """The port exports the JAX package's names but for its Pallas model
    spec, ``from_torch_callable``, ``ops`` and the version."""
    jax_only = {"PallasModelSpec", "make_pallas_model_spec", "from_torch_callable", "ops",
                "__version__"}
    assert set(lt.__all__) == set(lmc.__all__) - jax_only
    for name in lt.__all__:
        assert getattr(lt, name) is not None, name
    assert lt.warnings_from_stats is lt.report.warnings_from_stats
    assert lt.utils.device_trace is not None and lt.models.LinearRegression is not None
    assert lt.parallel.chain_mesh is not None and lt.parallel.initialize_distributed is not None


def test_to_arviz():
    pytest.importorskip("arviz")
    from littlemcmc_torch.utils.diagnostics import to_arviz

    trace, stats = lt.sample(_plain_model, model_ndim=2, chains=2, tune=5, draws=5, **_BASE)
    idata = to_arviz(trace, stats)
    assert idata.posterior["x"].shape == (2, 5, 2)
    assert "acceptance_rate" in idata.sample_stats


def test_start_of_trajectory_matches_jax():
    """``base.start_of_trajectory``: the metric's momentum from the
    generator and the start state from the cached logp and gradient, as
    the JAX package's ``recompute_with_momentum`` gives at that momentum."""
    from littlemcmc_tpu.integration import recompute_with_momentum as jax_recompute
    from littlemcmc_tpu.quadpotential import QuadPotentialDiag as JDiag
    from littlemcmc_torch.base import start_of_trajectory

    rng = np.random.default_rng(0)
    q0 = rng.standard_normal((3, 4)).astype(np.float32)
    var = np.array([0.5, 1.0, 2.0, 4.0], np.float32)
    pot = lt.QuadPotentialDiag.create(torch.from_numpy(var)).broadcast(3)
    state = lt.init_chain_state(torch.from_numpy(q0), pot, lt.NUTSConfig(),
                                torch.func.vmap(_plain_model))
    start = start_of_trajectory(state, torch.Generator().manual_seed(4))
    p0 = pot.sample_momentum(torch.Generator().manual_seed(4))
    assert torch.equal(start.p, p0)
    jpot = JDiag.create(jnp.asarray(var))
    for c in range(3):
        want = jax_recompute(jpot, jnp.asarray(q0[c]), jnp.asarray(-q0[c]),
                             jnp.asarray(-0.5 * (q0[c] ** 2).sum()), jnp.asarray(p0[c].numpy()))
        np.testing.assert_allclose(start.energy[c].item(), float(want.energy), rtol=1e-6)
        np.testing.assert_allclose(start.v[c].numpy(), np.asarray(want.v), rtol=1e-6)


@pytest.mark.parametrize("cls", ["NUTSConfig", "HMCConfig"])
def test_config_carries_across_from_jax(cls):
    import dataclasses

    from littlemcmc_tpu import base as jbase
    from littlemcmc_torch.convert import config_from_fields, config_to_fields

    jcfg = getattr(jbase, cls)(target_accept=0.9, chain_block=16)
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    assert type(cfg).__name__ == cls and cfg.target_accept == 0.9 and cfg.chain_block == 16
    assert config_to_fields(cfg) == dataclasses.asdict(jcfg)
    with pytest.raises(ValueError, match="no field"):
        config_from_fields({**dataclasses.asdict(jcfg), "pallas_interpret": True})
