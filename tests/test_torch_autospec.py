"""The port's auto-lowering of a torch model into the kernels' body
(``littlemcmc_torch.ops.autospec``), held against the JAX package on the
CPU, where no ``nvcc`` and no card are.

- (a) each model of the JAX probe matrix (``tests/test_autospec.py:
  309-350``, written in torch with the same numpy data) and
  ``HierarchicalRegression``: the generated spec's plain body against the
  JAX ``make_pallas_model_spec(...).fn`` at the same q, and the numpy
  interpreter of the lowered program (slots, index maps, segment sums)
  against the traced graph;
- (b) the emitted source is deterministic, and a model that does not lower
  (a numpy callable, an op outside the set, Python control flow on q, too
  wide) declines with a log line and samples on the tree;
- (c) ``probe_spec`` needs the card and raises on the CPU;
- (d) ``sample()`` through an explicit generated spec on the plain
  trajectory: the JAX test's posterior parity (``tests/test_autospec.py:
  240-259``) and hierarchical group means (``:144-172``);
- (e) ``HierarchicalRegression``'s data equal the JAX model's to the bit,
  and its logp and grad.

Run as a script (``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_autospec.py``, about a minute) it rewrites
``tests/hierarchical_reference_moments.json`` from a long run of the JAX
package on the CPU.
"""

import json
import logging
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
from littlemcmc_tpu.ops import make_pallas_model_spec
from littlemcmc_tpu.ops.nuts_trajectory_pallas import padded_dim
from littlemcmc_tpu.utils.diagnostics import ess_bulk, split_rhat
from littlemcmc_torch import models as tm
from littlemcmc_torch.model import from_numpy_callable
from littlemcmc_torch.models.probe_matrix import autospec_matrix
from littlemcmc_torch.ops import autospec
from littlemcmc_torch.ops.autospec import make_trajectory_spec, try_auto_spec


torch.set_num_threads(1)

HIER_REFERENCE = Path(__file__).resolve().parent / "hierarchical_reference_moments.json"
HIER_REF_RUN = dict(chains=128, tune=1000, draws=2000, random_seed=2024, target_accept=0.9)


def hierarchical_reference_moments(chains, tune, draws, random_seed, target_accept):
    """The 42 posterior means and sds of ``HierarchicalRegression()`` (32
    groups, 512 rows, 8 features, seed 11) from one long run of the JAX
    package's NUTS on the CPU (its tensor-op tree, jitter+adapt_diag), with
    each mean's Monte Carlo standard error from the bulk ESS."""
    model = jm.HierarchicalRegression()
    trace, stats = lmc.sample(logp_dlogp_func=model.logp_grad, model_ndim=model.ndim,
                              chains=chains, tune=tune, draws=draws, random_seed=random_seed,
                              target_accept=target_accept, progressbar=False)
    trace = np.asarray(trace, np.float64)
    flat = trace.reshape(-1, model.ndim)
    sd = flat.std(0)
    ess = np.array([ess_bulk(trace[:, :, i]) for i in range(model.ndim)])
    return {
        "source": "littlemcmc_tpu.sample(HierarchicalRegression().logp_grad) on the CPU",
        "command": "JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_autospec.py",
        **{k: int(v) for k, v in dict(chains=chains, tune=tune, draws=draws,
                                      random_seed=random_seed).items()},
        "target_accept": float(target_accept),
        "mean": flat.mean(0).tolist(),
        "sd": sd.tolist(),
        "mcse_mean": (sd / np.sqrt(ess)).tolist(),
        "min_bulk_ess": float(ess.min()),
        "max_split_rhat": float(max(split_rhat(trace[:, :, i]) for i in range(model.ndim))),
        "divergence_rate": float(np.asarray(stats["diverging"]).mean()),
        "mean_depth": float(np.asarray(stats["depth"]).mean()),
    }


# --------------------------------------------------------------------------
# (a) the probe matrix and the hierarchical regression
# --------------------------------------------------------------------------

def _matrix():
    """The JAX probe matrix's nine models in both packages, on the same
    numpy data: name -> (JAX logp, torch logp); the torch ones are the
    card's (``littlemcmc_torch.models.probe_matrix``)."""
    n = 3
    X = jnp.asarray(np.random.RandomState(0).randn(50, n).astype(np.float32))
    y = jnp.asarray((np.random.RandomState(1).rand(50) > 0.5).astype(np.float32))
    G = jnp.asarray(np.random.RandomState(2).randint(0, n, 50))
    torch_models = autospec_matrix("cpu")
    jax_models = {
        "gaussian_quadratic": lambda b: -0.5 * jnp.sum((X @ b) ** 2),
        "logistic": lambda b: jnp.sum(y * jax.nn.log_sigmoid(X @ b)
                                      + (1 - y) * jax.nn.log_sigmoid(-(X @ b)))
        - 0.5 * jnp.sum(b ** 2),
        "poisson_loglink": lambda b: jnp.sum(y * (X @ b) - jnp.exp(jnp.clip(X @ b, -10, 10))),
        "student_t": lambda b: -jnp.sum(2.0 * jnp.log1p((X @ b) ** 2 / 4.0)),
        "laplace_prior": lambda b: jnp.sum(y * (X @ b)) - jnp.sum(jnp.abs(b))
        - 0.05 * jnp.sum((X @ b) ** 2),
        "hierarchical_ncp": lambda b: -0.5 * b[0] ** 2
        - 0.5 * jnp.sum((b[1:] - b[0]) ** 2 * jnp.exp(-b[0])),
        "softplus_link": lambda b: -jnp.sum((y - jax.nn.softplus(X @ b)) ** 2)
        - 0.5 * jnp.sum(b ** 2),
        "piecewise": lambda b: jnp.sum(jnp.where(X @ b > 0, -(X @ b) ** 2, X @ b)) * 0.1,
        "hierarchical_gather": lambda b: (
            -0.5 * jnp.sum((y - jnp.take(b, G)) ** 2)
            - 0.1 * jnp.sum(jax.ops.segment_sum((y - jnp.take(b, G)) ** 2, G, num_segments=n))
            - 0.5 * jnp.sum(b ** 2)),
    }
    return {k: (jax_models[k], torch_models[k]) for k in jax_models}


MATRIX = list(_matrix()) + ["hierarchical_regression"]


@pytest.fixture(scope="module")
def matrix_specs():
    """name -> (JAX spec, port spec, ndim)."""
    out = {}
    for name, (jf, tf) in _matrix().items():
        out[name] = (make_pallas_model_spec(ndim=3, logp_fn=jf),
                     make_trajectory_spec(ndim=3, logp_fn=tf, device="cpu", name=name), 3)
    jh, th = jm.HierarchicalRegression(), tm.HierarchicalRegression(device="cpu")
    out["hierarchical_regression"] = (jh.pallas_trajectory_spec(), th.trajectory_spec(),
                                      th.ndim)
    return out


def _qs(n, seed=5):
    """8 positions at the probe's three scales (0.1, 1, 5)."""
    q = np.random.RandomState(seed).randn(8, n).astype(np.float32)
    return q * np.asarray([0.1, 1.0, 5.0], np.float32)[np.arange(8) % 3, None]


@pytest.mark.parametrize("name", MATRIX)
def test_generated_body_matches_jax_spec_fn(matrix_specs, name):
    """(a) the port's plain body (the traced graph, vmapped) against the
    JAX spec's ``fn`` (the jaxpr replayed with its one-hot rewrites) at 8
    positions: rtol 1e-5, atol 1e-5 of the values' size (sums of up to
    512 float32 terms in two orders)."""
    jspec, tspec, n = matrix_specs[name]
    q = _qs(n)
    qp = np.zeros((8, padded_dim(n)), np.float32)
    qp[:, :n] = q
    lp, g = (np.asarray(x) for x in jax.jit(jspec.fn)(jnp.asarray(qp), *jspec.consts))
    tlp, tg = (x.numpy() for x in tspec.auto.plain(torch.from_numpy(q)))
    scale = 1.0 + np.abs(lp[:, 0])
    np.testing.assert_allclose(tlp / scale, lp[:, 0] / scale, rtol=1e-5, atol=1e-5)
    gscale = 1.0 + np.abs(g[:, :n]).max(1, keepdims=True)
    np.testing.assert_allclose(tg / gscale, g[:, :n] / gscale, rtol=1e-5, atol=1e-5)
    assert tspec.body == "auto" and not tspec.packable and tspec.ndim == n


@pytest.mark.parametrize("name", MATRIX)
def test_interpreter_matches_graph(matrix_specs, name):
    """(a) the lowered program run in numpy (:func:`autospec.interpret`:
    every slot, index map and segment sum the kernel uses) gives the
    graph's ``(logp, grad)`` at 8 positions, within 1e-5 of their size."""
    _, tspec, n = matrix_specs[name]
    prog = tspec.auto
    q = _qs(n, seed=6)
    lp, g = (x.numpy() for x in prog.plain(torch.from_numpy(q)))
    for c in range(8):
        ilp, ig = autospec.interpret(prog, q[c])
        np.testing.assert_allclose(ilp / (1.0 + abs(lp[c])), lp[c] / (1.0 + abs(lp[c])),
                                   rtol=1e-5, atol=1e-5)
        gs = 1.0 + np.abs(g[c]).max()
        np.testing.assert_allclose(ig / gs, g[c] / gs, rtol=1e-5, atol=1e-5)
    assert prog.scratch_floats <= autospec.MAX_SCRATCH_FLOATS and prog.flops > 0


def test_hierarchical_program_gathers_and_scatters(matrix_specs):
    """(a) the hierarchical body lowers ``z[g]`` to a gather and its VJP to
    a segment sum (512 terms into 32 groups), and reuses scratch slots."""
    prog = matrix_specs["hierarchical_regression"][1].auto
    ops = [i.op for i in prog.instrs]
    assert "gather" in ops and "segment" in ops and "mv" in ops
    seg = next(i for i in prog.instrs if i.op == "segment")
    assert prog.values[seg.out].shape == (32,) and prog.values[seg.ins[1]].shape == (512,)
    slots = sum(v.numel for v in {id(prog.values[i.out]): prog.values[i.out]
                                  for i in prog.instrs
                                  if prog.values[i.out].kind == "slot"}.values())
    assert prog.scratch_floats < slots


def test_hierarchical_program_fuses_into_few_loops(matrix_specs):
    """(a) the hierarchical body's 59 ops run as far fewer loops, each
    ending in one ``__syncwarp()``: consecutive ops over one shape, and
    the reductions of their values, share a loop and keep their values in
    its registers (``local``); the thin ``X^T r`` product splits its sums
    across the lanes."""
    prog = matrix_specs["hierarchical_regression"][1].auto
    loops = [st for st in prog.steps if st.shape is not None and not st.rows]
    assert len(prog.instrs) == 59
    assert len(loops) == prog.body.count("for (int i = lane;") < 20
    assert prog.body.count("__syncwarp();") < 20
    assert max(len(st.instrs) for st in loops) >= 7
    assert any(v.kind == "local" for v in prog.values)
    assert [st.instrs[0].op for st in prog.steps if st.rows] == ["mv"]


def test_hierarchical_program_needs_less_scratch(matrix_specs):
    """(a) only values read at another element or after their loop keep a
    slot: the hierarchical body needs fewer scratch floats a chain than
    the 2,592 it took with every value of more than one element in a
    slot, and no more than its kept values' sum."""
    prog = matrix_specs["hierarchical_regression"][1].auto
    kept = {v.buf: v.numel for v in prog.values if v.kind == "slot"}
    assert prog.scratch_floats < 2592
    assert prog.scratch_floats <= sum(kept.values())


def test_fusion_keeps_the_program_and_its_flops(matrix_specs):
    """(a) fusing reorders no op's inputs and drops or adds none: the
    fused steps hold the unfused program's ops (lowered again from the
    traced graph), each after the ops it reads, and ``Program.flops``
    counts the same arithmetic, 23,899 operations for the hierarchical
    body (its kernel row's bound counts them)."""
    for name in ("hierarchical_regression", "logistic", "hierarchical_gather"):
        prog = matrix_specs[name][1].auto
        low = autospec._Lowering(prog.graph, prog.ndim)
        lp, g = low.run()
        plain_ops = autospec._live(low.values, low.instrs, (lp, g))
        assert sorted((i.op, i.fn) for i in plain_ops) == sorted((i.op, i.fn) for i in prog.instrs)
        assert prog.flops == sum(autospec._flops(low.values, i) for i in plain_ops)
        made = set()
        for ins in prog.instrs:
            assert all(prog.values[v].buf in made or prog.values[v].kind != "slot"
                       for v in ins.ins), name
            made.add(prog.values[ins.out].buf)
    assert matrix_specs["hierarchical_regression"][1].auto.flops == 23899


def test_interpreter_catches_a_value_read_outside_its_loop(matrix_specs):
    """(a) the interpreter keeps a loop's registers to that loop: a kept
    value planted as ``local`` (no slot) is read by a later step and the
    run fails, where reading the scratch would have hidden the fault."""
    prog = matrix_specs["hierarchical_regression"][1].auto
    home = {prog.values[i.out].buf: k for k, st in enumerate(prog.steps)
            if st.shape is not None and not st.rows for i in st.instrs if i.op != "reduce"}
    later = next(v.buf for k, st in enumerate(prog.steps) for i in st.instrs for v in
                 (prog.values[x] for x in i.ins) if v.kind == "slot" and home.get(v.buf, k) < k)
    planted = [v for v in prog.values if v.buf == later]
    try:
        for v in planted:
            v.kind = "local"
        with pytest.raises(AssertionError, match="outside its loop"):
            autospec.interpret(prog, _qs(prog.ndim)[0])
    finally:
        for v in planted:
            v.kind = "slot"


# --------------------------------------------------------------------------
# (b) the source, and the declines
# --------------------------------------------------------------------------

def test_emitted_source_is_deterministic():
    """(b) two traces of one model emit the same source and hash; another
    model another hash; the header holds the body and the scratch binder."""
    a = tm.HierarchicalRegression(device="cpu").trajectory_spec().auto
    b = tm.HierarchicalRegression(device="cpu").trajectory_spec().auto
    c = make_trajectory_spec(ndim=3, logp_fn=_matrix()["logistic"][1], device="cpu").auto
    assert a.body == b.body and a.digest == b.digest != c.digest
    head = autospec.header_source(a)
    assert "namespace autobody" in head and "autospec_bind_scratch" in head
    assert f"kScratchFloats = {a.scratch_floats}" in head
    probe = autospec.probe_header([a, c])
    assert "autobody_0" in probe and "autobody_1" in probe and "autoprobe" in probe


def test_fused_source_is_the_same_in_every_process():
    """(b) the fused body does not depend on the order of a hash: two
    processes with other hash seeds emit the hierarchical body and a probe
    matrix model with the same digests (the build's cache key)."""
    import os
    import subprocess

    code = ("import torch; from littlemcmc_torch import models as tm; "
            "from littlemcmc_torch.models.probe_matrix import autospec_matrix; "
            "from littlemcmc_torch.ops.autospec import make_trajectory_spec; "
            "print(tm.HierarchicalRegression(device='cpu').trajectory_spec().auto.digest, "
            "make_trajectory_spec(ndim=3, logp_fn=autospec_matrix('cpu')['hierarchical_gather'], "
            "device='cpu').auto.digest)")
    root = str(Path(__file__).resolve().parents[1])
    digests = [subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              check=True, cwd=root,
                              env={**os.environ, "PYTHONHASHSEED": seed}).stdout.split()
               for seed in ("1", "2")]
    assert digests[0] == digests[1] and len(digests[0]) == 2


def _numpy_model(x):
    return float(-0.5 * np.sum(x ** 2)), -x


DECLINES = {
    "numpy_callable": (lambda: from_numpy_callable(_numpy_model, 3), False, 3),
    "unsupported_op": (lambda: (lambda q: -torch.sum(torch.cumsum(q, 0) ** 2)), True, 3),
    "control_flow": (lambda: (lambda q: -q.sum() if q[0] > 0 else q.sum()), True, 3),
    "too_wide": (lambda: (lambda q: -0.5 * torch.sum(q * q)), True, autospec.MAX_NDIM + 1),
}


@pytest.mark.parametrize("case", list(DECLINES))
def test_decline_logs_and_samples_on_the_tree(case, caplog):
    """(b) a model outside the op set declines at trace time: ``None``
    from ``try_auto_spec`` with an info log line, and ``sample`` runs it
    on the tensor-op tree (``sample`` on the CPU auto-lowers nothing, as
    the JAX package on the CPU)."""
    make, logp_only, n = DECLINES[case]
    fn = make()
    with caplog.at_level(logging.INFO, logger="littlemcmc_torch"):
        assert try_auto_spec(fn, n, logp_only, device="cpu") is None
    assert any("not auto-lowerable" in r.message and "tensor-op tree" in r.message
               for r in caplog.records)
    if case in ("too_wide", "control_flow"):
        return  # the tree vmaps the model, which Python control flow on q also stops
    report = {}
    kw = dict(logp_fn=fn) if logp_only else dict(logp_dlogp_func=fn)
    trace, _ = lt.sample(model_ndim=n, chains=4, tune=5, draws=5, random_seed=1, device="cpu",
                         perf_report=report, progressbar=False,
                         compute_convergence_checks=False, **kw)
    assert report["trajectory"] == "tensor" and np.isfinite(trace).all()


def test_lowering_fault_raises_and_does_not_fall_back(monkeypatch):
    """(b) only a trace-time decline leads to the tree: a fault planted in
    the emitter propagates from ``try_auto_spec`` and from ``sample()``'s
    spec resolution for the card (its device type ``cuda``, the lowering
    on the CPU), and is not cached."""
    from littlemcmc_torch import sampling

    def broken(self, ins):
        raise AssertionError("planted emitter fault")

    fn = _matrix()["logistic"][1]
    monkeypatch.setattr(autospec._Emitter, "emit", broken)
    with pytest.raises(AssertionError, match="planted"):
        try_auto_spec(fn, 3, True, device="cpu")
    class Unhashable:
        __hash__ = None

        def __call__(self, q):
            return fn(q)

    with pytest.raises(AssertionError, match="planted"):
        try_auto_spec(Unhashable(), 3, True, device="cpu")
    monkeypatch.setattr(autospec, "resolve_device", lambda device=None: torch.device("cpu"))
    step = lt.NUTS(model_ndim=3)
    with pytest.raises(AssertionError, match="planted"):
        sampling._resolve_spec(step, None, False, fn, True, 3, torch.device("cuda"))
    monkeypatch.undo()
    assert try_auto_spec(fn, 3, True, device="cpu") is not None


def test_sample_on_the_cpu_keeps_user_models_on_the_tree():
    """(b) with ``trajectory_spec="auto"`` on the CPU a lowerable user
    model runs the tree, as in the JAX package on the CPU."""
    report = {}
    lt.sample(logp_fn=_matrix()["student_t"][1], model_ndim=3, chains=4, tune=5, draws=5,
              random_seed=1, device="cpu", perf_report=report, progressbar=False,
              compute_convergence_checks=False)
    assert report["trajectory"] == "tensor" and report["engine"] == "per_draw_diag"


# --------------------------------------------------------------------------
# (c) the probe
# --------------------------------------------------------------------------

def test_probe_spec_needs_the_card(matrix_specs):
    """(c) the probe runs the generated body on the card: on the CPU it
    raises rather than pass a body nothing ran."""
    with pytest.raises(RuntimeError, match="CUDA card"):
        autospec.probe_spec(matrix_specs["logistic"][1])
    assert not matrix_specs["logistic"][1].auto.probed


# --------------------------------------------------------------------------
# (d) sample() through a generated spec on the plain trajectory
# --------------------------------------------------------------------------

def _jax_logistic(n=4, N=60, seed=3):
    """``tests/test_autospec.py::_logistic_model`` in both packages."""
    rng = np.random.RandomState(seed)
    Xn = rng.randn(N, n).astype(np.float32)
    yn = (rng.rand(N) > 0.5).astype(np.float32)
    X, y = jnp.asarray(Xn), jnp.asarray(yn)
    Xt, yt = torch.from_numpy(Xn), torch.from_numpy(yn)
    F = torch.nn.functional

    def jf(beta):
        z = X @ beta
        return (jnp.sum(y * jax.nn.log_sigmoid(z) + (1 - y) * jax.nn.log_sigmoid(-z))
                - 0.5 * jnp.sum(beta ** 2))

    def tf(beta):
        z = Xt @ beta
        return (torch.sum(yt * F.logsigmoid(z) + (1 - yt) * F.logsigmoid(-z))
                - 0.5 * torch.sum(beta ** 2))

    return jf, tf


def test_generated_spec_sample_matches_jax_tree():
    """(d) a user model sampled through its generated spec on the plain
    trajectory against the JAX package's tree on the same model
    (``tests/test_autospec.py:240-259``): means within 0.1, sds within
    20%, the accept rate of the last 100 draws in (0.6, 0.95)."""
    jf, tf = _jax_logistic()
    spec = make_trajectory_spec(ndim=4, logp_fn=tf, device="cpu")
    report = {}
    tr_p, st_p = lt.sample(logp_fn=tf, model_ndim=4, chains=16, tune=200, draws=400,
                           random_seed=8, device="cpu", perf_report=report,
                           step=lt.NUTS(model_ndim=4, trajectory_spec=spec), progressbar=False)
    assert report["engine"] == "per_draw_diag" and report["trajectory"] == "plain"
    tr_x, _ = lmc.sample(logp_fn=jf, model_ndim=4, chains=16, tune=200, draws=400,
                         random_seed=8, progressbar=False)
    tr_x = np.asarray(tr_x)
    np.testing.assert_allclose(tr_p.reshape(-1, 4).mean(0), tr_x.reshape(-1, 4).mean(0),
                               atol=0.1)
    np.testing.assert_allclose(tr_p.reshape(-1, 4).std(0) / tr_x.reshape(-1, 4).std(0), 1.0,
                               atol=0.2)
    assert 0.6 < st_p["mean_tree_accept"][:, -100:].mean() < 0.95


def test_hierarchical_gather_model_recovers_group_means():
    """(d) the JAX test's group-indexed model (``tests/test_autospec.py:
    144-172``: ``take`` and ``segment_sum``), written in torch with
    ``theta[groups]`` and ``index_add``, through its generated spec on the
    plain trajectory: each group's posterior mean within 0.35 of its
    data mean, divergences under 2%."""
    J = 4
    rng = np.random.RandomState(3)
    groups = rng.randint(0, J, 40)
    truth = np.array([1.0, -1.0, 0.5, 0.0], np.float32)
    yobs = (rng.randn(40).astype(np.float32) * 0.5 + truth[groups]).astype(np.float32)
    gt, yt = torch.from_numpy(groups), torch.from_numpy(yobs)

    def logp(q):
        theta = q[1:]
        resid = yt - theta[gt]
        per_group = torch.zeros(J).index_add(0, gt, resid ** 2)
        return (-0.5 * torch.sum(per_group) - 0.5 * torch.sum((theta - q[0]) ** 2)
                - 0.05 * q[0] ** 2)

    spec = make_trajectory_spec(ndim=1 + J, logp_fn=logp, device="cpu")
    trace, stats = lt.sample(logp_fn=logp, model_ndim=1 + J, chains=8, tune=300, draws=500,
                             random_seed=2, device="cpu", progressbar=False,
                             step=lt.NUTS(model_ndim=1 + J, trajectory_spec=spec))
    tr = trace.reshape(-1, 1 + J)
    for g in range(J):
        assert abs(tr[:, 1 + g].mean() - yobs[groups == g].mean()) < 0.35
    assert stats["diverging"].mean() < 0.02


# --------------------------------------------------------------------------
# (e) the hierarchical regression
# --------------------------------------------------------------------------

def test_hierarchical_regression_matches_jax_model():
    """(e) the data bit for bit; logp and grad at 8 positions near the
    reference posterior within 1e-5 of their size (the JAX model's
    ``jnp.take`` and the port's ``z[g]``)."""
    jmodel, tmodel = jm.HierarchicalRegression(), tm.HierarchicalRegression(device="cpu")
    np.testing.assert_array_equal(tmodel.g.numpy(), np.asarray(jmodel._g))
    np.testing.assert_array_equal(tmodel.X.numpy(), np.asarray(jmodel._X))
    np.testing.assert_array_equal(tmodel.y.numpy(), np.asarray(jmodel._y))
    assert tmodel.ndim == jmodel.ndim == 42
    ref = json.loads(HIER_REFERENCE.read_text())
    q = (np.array(ref["mean"]) + np.array(ref["sd"])
         * np.random.RandomState(4).randn(8, 42)).astype(np.float32)
    lp, g = (np.asarray(x) for x in jmodel.batched_logp_grad(jnp.asarray(q)))
    tlp, tg = (x.numpy() for x in tmodel.batched_logp_grad(torch.from_numpy(q)))
    np.testing.assert_allclose(tlp / np.abs(lp), lp / np.abs(lp), atol=1e-5)
    gs = 1.0 + np.abs(g).max(1, keepdims=True)
    np.testing.assert_allclose(tg / gs, g / gs, atol=1e-5)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    HIER_REFERENCE.write_text(json.dumps(hierarchical_reference_moments(**HIER_REF_RUN),
                                         indent=1) + "\n")
    print(HIER_REFERENCE.read_text())
    sys.exit(0)
