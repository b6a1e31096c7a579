"""Checkpoint/resume and the chunked runner's surface
(``littlemcmc_torch.utils.checkpoint``, ``sample(progress_every=...,
callback=..., checkpoint_dir=..., checkpoint_every=..., resume=...)``),
held against the JAX package's ``tests/test_checkpoint.py`` on the CPU.

The JAX file's six tests are ported case for case, each on the port's
engines: the tensor-op tree (a plain closure), the per-draw kernel engine
(a model with a body, the kernel's plain version) and the fused engine
(``fuse_draws=True``, the fused op's plain version). Resuming from a
checkpoint gives an uninterrupted run's bits; an interrupt between chunks
returns the chunks completed and checkpoints them. The checkpoint layout
(``step_%08d`` directories, the meta's keys) is the JAX package's.
"""

import json
import os

import numpy as np
import pytest
import torch

import littlemcmc_tpu as lmc
import littlemcmc_torch as lt
from littlemcmc_torch.models import CorrelatedGaussian, StandardNormal
from littlemcmc_torch.utils.checkpoint import (latest_checkpoint, restore_checkpoint,
                                               save_checkpoint)
from tests.conftest import std_normal_logp_grad

torch.set_num_threads(1)


def _plain(q):
    return -0.5 * (q * q).sum(), -q


def _engine(name):
    """``sample`` keywords of one engine and the engine name it stamps."""
    if name == "tree":
        return dict(logp_dlogp_func=_plain, model_ndim=2, chains=2), "per_draw_diag"
    m = CorrelatedGaussian(4, device="cpu")
    kw = dict(logp_dlogp_func=m.logp_grad, model_ndim=4, chains=8)
    if name == "fused":
        return dict(kw, fuse_draws=True), "fused_diag"
    if name == "fused_dense":
        return dict(kw, fuse_draws=True, init="adapt_full", cross_chain_adapt=True), \
            "fused_dense_pooled"
    if name == "hmc_tensor":
        return dict(logp_dlogp_func=_plain, model_ndim=2, chains=2,
                    step=lt.HamiltonianMC(model_ndim=2)), "per_draw_diag"
    return kw, "per_draw_diag"


ENGINES = ["tree", "kernel", "fused", "hmc_tensor"]
BASE = dict(device="cpu", progressbar=False, compute_convergence_checks=False)


@pytest.mark.parametrize("engine", ENGINES)
def test_chunked_equals_oneshot(engine):
    kw, _ = _engine(engine)
    t_one, s_one = lt.sample(draws=80, tune=60, random_seed=9, **BASE, **kw)
    t_chunk, s_chunk = lt.sample(draws=80, tune=60, random_seed=9, progress_every=25,
                                 **BASE, **kw)
    np.testing.assert_array_equal(t_one, t_chunk)
    for k in s_one:
        np.testing.assert_array_equal(s_one[k], s_chunk[k])


@pytest.mark.parametrize("engine", ENGINES + ["fused_dense"])
def test_checkpoint_and_resume_bit_identical(engine, tmp_path):
    kw, stamp = _engine(engine)
    ckpt = str(tmp_path / "ckpt")
    kw = dict(draws=60, tune=40, random_seed=17, **BASE, **kw)
    rep = {}
    t_full, _ = lt.sample(checkpoint_dir=ckpt, checkpoint_every=30, perf_report=rep, **kw)
    assert rep["engine"] == stamp and rep["chunk"] == 30
    last = latest_checkpoint(ckpt)
    assert last is not None and last.endswith("step_00000090")
    assert sorted(os.listdir(ckpt)) == ["step_00000030", "step_00000060", "step_00000090"]
    t_resumed, s_resumed = lt.sample(checkpoint_dir=ckpt, resume=True, **kw)
    # only the post-restore draws: iterations 90..100, all sampling
    assert t_resumed.shape == (kw.get("chains"), 10, kw["model_ndim"])
    np.testing.assert_array_equal(t_resumed, t_full[:, -10:, :])
    if engine != "fused_dense":
        # a pooled metric refreshes at every chunk boundary on the fused
        # engine: only there does the chunking move the draws
        t_plain, _ = lt.sample(**kw)
        np.testing.assert_array_equal(t_plain, t_full)


def test_checkpoint_layout_matches_jax(tmp_path):
    """Both packages write ``step_%08d`` directories at the same iterations
    and the same meta keys for the same run."""
    kw = dict(model_ndim=2, draws=60, tune=40, chains=2, random_seed=17, progressbar=False,
              checkpoint_every=30)
    lmc.sample(logp_dlogp_func=std_normal_logp_grad, checkpoint_dir=str(tmp_path / "j"), **kw)
    lt.sample(logp_dlogp_func=_plain, checkpoint_dir=str(tmp_path / "t"), device="cpu", **kw)
    jdirs = sorted(d for d in os.listdir(tmp_path / "j") if d.startswith("step_"))
    tdirs = sorted(os.listdir(tmp_path / "t"))
    assert jdirs == tdirs == ["step_00000030", "step_00000060", "step_00000090"]
    with open(tmp_path / "j" / "step_00000090" / "littlemcmc_tpu_meta.json") as f:
        jmeta = json.load(f)
    _, tmeta = restore_checkpoint(str(tmp_path / "t" / "step_00000090"))
    assert set(jmeta) == set(tmeta) - {"extra"}
    assert {k: tmeta[k] for k in jmeta} == {**jmeta, "n_divergences": tmeta["n_divergences"]}


def test_resume_requires_dir():
    with pytest.raises(ValueError, match="checkpoint_dir"):
        lt.sample(_plain, model_ndim=1, draws=10, tune=10, chains=2, resume=True, **BASE)


def _state(kind, chains=3, n=3):
    from littlemcmc_torch.sampling import _make_adaptive_potential

    q0 = torch.linspace(-1, 1, chains * n).reshape(chains, n)
    if kind in ("diag", "full", "lowrank"):
        pot = _make_adaptive_potential(kind, q0)
    elif kind == "static_diag":
        pot = lt.QuadPotentialDiag.create(torch.full((n,), 2.0)).broadcast(chains)
    elif kind == "static_full":
        pot = lt.quad_potential(torch.eye(n) * 2.0, True).broadcast(chains)
    else:
        pot = lt.QuadPotentialFullInv.create(torch.eye(n) * 0.5).broadcast(chains)
    return lt.init_chain_state(q0, pot, lt.NUTSConfig(), torch.func.vmap(_plain))


@pytest.mark.parametrize("kind", ["diag", "full", "lowrank", "static_diag", "static_full",
                                  "inv"])
def test_checkpoint_roundtrip_state(kind, tmp_path):
    """Direct save/restore of a chain state with each metric class, read
    back with ``weights_only=True``."""
    state = _state(kind)
    gen = torch.Generator().manual_seed(3)
    path = save_checkpoint(str(tmp_path / "c"), state, 5, meta={"x": 1},
                           extra={"generator": gen.get_state(), "seed_words": [1, -2]})
    payload = torch.load(os.path.join(path, "state.pt"), weights_only=True)
    assert payload["state"]["potential"]["class"] == type(state.potential).__name__
    restored, meta = restore_checkpoint(path, state)
    assert meta["step"] == 5 and meta["x"] == 1 and meta["extra"]["seed_words"] == [1, -2]
    assert torch.equal(meta["extra"]["generator"], gen.get_state())
    assert type(restored.potential) is type(state.potential)
    for a, b in ((restored.q, state.q), (restored.logp, state.logp),
                 (restored.iter_count, state.iter_count), (restored.da.mu, state.da.mu),
                 (restored.da.count, state.da.count)):
        assert torch.equal(a, b)
    import dataclasses

    for f in dataclasses.fields(state.potential):
        a, b = getattr(restored.potential, f.name), getattr(state.potential, f.name)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        elif dataclasses.is_dataclass(b):
            for g in dataclasses.fields(b):
                assert torch.equal(getattr(a, g.name), getattr(b, g.name)), (f.name, g.name)
        else:
            assert a == b, f.name


def test_restore_checks_the_template(tmp_path):
    path = save_checkpoint(str(tmp_path / "c"), _state("diag"), 1)
    with pytest.raises(ValueError, match="QuadPotentialDiagAdapt"):
        restore_checkpoint(path, _state("full"))
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(path, _state("diag", chains=4))


def test_interrupt_between_fused_chunks(tmp_path):
    """KeyboardInterrupt between fused chunks returns the completed chunks
    and an interrupt checkpoint, and resume finishes the run on the fused
    engine with an uninterrupted run's bits."""
    model = StandardNormal(2, device="cpu")
    ckpt = str(tmp_path / "ckpt_fused_int")
    kw = dict(logp_dlogp_func=model.logp_grad, model_ndim=2, draws=80, tune=40, chains=8,
              random_seed=11, fuse_draws=True, **BASE)
    calls = []

    def interrupting_cb(iteration, tuning, states, chunk, n_divergences):
        calls.append((iteration, tuning))
        if iteration >= 60:  # tune=40 + one collected 20-draw fused chunk
            raise KeyboardInterrupt

    rep = {}
    t_part, s_part = lt.sample(progress_every=20, callback=interrupting_cb,
                               checkpoint_dir=ckpt, checkpoint_every=20, perf_report=rep,
                               **kw)
    assert rep["engine"] == "fused_diag" and rep["kernel_launches"]["fused_nuts"] == 0
    assert t_part.shape == (8, 20, 2)
    assert s_part["depth"].shape == (8, 20)
    assert (60, False) in calls
    last = latest_checkpoint(ckpt)
    assert last is not None and last.endswith("step_00000060")
    t_rest, _ = lt.sample(checkpoint_dir=ckpt, resume=True, **kw)
    assert t_rest.shape == (8, 60, 2)
    t_full, _ = lt.sample(**kw)
    np.testing.assert_array_equal(np.concatenate([t_part, t_rest], axis=1), t_full)


@pytest.mark.parametrize("engine", ["tree", "kernel"])
def test_interrupt_returns_partial_trace_and_checkpoints(engine, tmp_path):
    kw, _ = _engine(engine)
    ckpt = str(tmp_path / "ckpt_int")
    kw = dict(draws=80, tune=40, random_seed=3, **BASE, **kw)
    seen = []

    def interrupting_cb(iteration, tuning, states, chunk, n_divergences):
        seen.append((iteration, tuning, chunk is None, isinstance(n_divergences, int)))
        if iteration >= 60:
            raise KeyboardInterrupt

    t_part, s_part = lt.sample(progress_every=20, callback=interrupting_cb,
                               checkpoint_dir=ckpt, checkpoint_every=20, **kw)
    assert t_part.shape[1] == 20 and s_part["depth"].shape[1] == 20
    # tuning chunks are not collected (discard_tuned_samples), so their
    # callback sees chunk=None
    assert seen == [(20, True, True, True), (40, True, True, True), (60, False, False, True)]
    assert latest_checkpoint(ckpt).endswith("step_00000060")
    t_rest, _ = lt.sample(checkpoint_dir=ckpt, resume=True, **kw)
    assert t_rest.shape[1] == 60
    t_full, _ = lt.sample(**kw)
    np.testing.assert_array_equal(np.concatenate([t_part, t_rest], axis=1), t_full)


def test_resume_warns_when_the_checkpoint_covered_draws(tmp_path, caplog):
    import logging

    ckpt = str(tmp_path / "c")
    kw = dict(model_ndim=2, draws=30, tune=20, chains=2, random_seed=1, **BASE)
    lt.sample(_plain, checkpoint_dir=ckpt, checkpoint_every=25, **kw)
    with caplog.at_level(logging.WARNING, logger="littlemcmc_torch"):
        trace, stats = lt.sample(_plain, checkpoint_dir=ckpt, resume=True, **kw)
    assert trace.shape == (2, 0, 2) and stats["depth"].shape == (2, 0)
    assert any("already covered 30 of the 30" in r.message for r in caplog.records)
