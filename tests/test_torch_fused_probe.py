"""The port's fused-kernel capability probes (``littlemcmc_torch.ops.
fused_probe``) against the JAX package's Mosaic probes on the CPU.

- each probe's inputs equal the ones the JAX probe hands its
  ``pallas_call`` (run in interpret mode, as the JAX package's own tests
  run it), and the port's plain version agrees with the interpret-mode
  outputs at the JAX probe's tolerance;
- on CPU tensors the kernel wrapper runs the plain version; the check
  needs the card and raises here;
- ``sample()`` runs the checks where the JAX election runs its probes:
  the fused ones where ``fuse_draws=None`` elects the fused engine, the
  low-rank one where a kernel runs the pooled low-rank metric, and none
  off the card.
"""

import jax
import jax.numpy as jnp  # noqa: F401  (the probes import it)
import numpy as np
import pytest
import torch
from jax.experimental import pallas

import littlemcmc_torch as lt
from littlemcmc_tpu.ops import fused_probe as jfp
from littlemcmc_torch import sampling
from littlemcmc_torch.models import NealsFunnel, SpikedGaussian
from littlemcmc_torch.ops import fused_probe as tfp

torch.set_num_threads(1)


def _jax_call(name, monkeypatch):
    """The inputs and outputs of the JAX probe's ``pallas_call``, run in
    interpret mode, and the probe's verdict."""
    real = pallas.pallas_call
    seen = []

    def spy(*a, **kw):
        call = real(*a, **kw)

        def run(*args):
            out = call(*args)
            seen.append(([np.asarray(x) for x in args],
                         [np.asarray(o) for o in (out if isinstance(out, (list, tuple))
                                                  else [out])]))
            return out
        return run

    monkeypatch.setattr(pallas, "pallas_call", spy)
    ok = getattr(jfp, f"probe_{name}")(interpret=True)
    monkeypatch.undo()
    assert len(seen) == 1
    return ok, seen[0]


@pytest.mark.parametrize("name", list(tfp.PROBES))
def test_probe_matches_jax_interpret(name, monkeypatch):
    ok, (jin, jout) = _jax_call(name, monkeypatch)
    assert ok
    tin = tfp.probe_inputs(name, "cpu")
    ins, outs = tfp._ARGS[name]
    assert len(jin) == len(ins)
    for k, x in zip(ins, jin):
        np.testing.assert_array_equal(tin[k].numpy(), x)
    want = tfp.probe_plain(name, tin)
    rtol, atol = tfp._TOL[name]
    for k, y in zip(outs, jout):
        got = want[k].numpy()
        if name == "stat_io_layout" and k == "st":
            y = y[:, :3]  # the probe writes three of the 16 stat columns
        if name == "smem_accumulate" and k == "cnt":
            y = y.reshape(1)
        assert got.shape == y.shape, k
        np.testing.assert_allclose(got, y, rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("name", list(tfp.PROBES))
def test_wrapper_runs_plain_on_cpu_and_check_needs_card(name):
    inputs = tfp.probe_inputs(name, "cpu")
    n0 = tfp.probe_kernel.launches[name]
    got = tfp.probe_kernel(name, inputs, "cpu")
    want = tfp.probe_plain(name, inputs)
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert tfp.probe_kernel.launches[name] == n0
    with pytest.raises(RuntimeError, match="CUDA card"):
        tfp.check_probe(name, "cpu")


def test_capability_checks_run_on_the_card_only(monkeypatch):
    calls = []
    monkeypatch.setattr(tfp, "fused_engine_check", lambda dev: calls.append(("fused", dev)))
    monkeypatch.setattr(tfp, "lowrank_kernel_check", lambda dev: calls.append(("lowrank", dev)))
    sampling._capability_checks(torch.device("cpu"), True, True)
    assert calls == []
    cuda = torch.device("cuda")
    sampling._capability_checks(cuda, True, False)
    sampling._capability_checks(cuda, False, True)
    sampling._capability_checks(cuda, False, False)
    assert calls == [("fused", cuda), ("lowrank", cuda)]
    assert tfp.FUSED_ENGINE_PROBES == ("cos", "grid_scratch", "stat_io_layout",
                                       "smem_accumulate", "block_outputs_3d")


ELECTIONS = {
    # name: (model, sample kwargs, engine, (fused_auto, lowrank_kernel))
    "fused_diag_auto": ("funnel", dict(), "fused_diag", (True, False)),
    "fused_diag_forced": ("funnel", dict(fuse_draws=True), "fused_diag", (False, False)),
    "per_draw_diag": ("funnel", dict(fuse_draws=False), "per_draw_diag", (False, False)),
    "fused_lowrank_pooled": ("spiked", dict(init="jitter+adapt_lowrank", cross_chain_adapt=True),
                             "fused_lowrank_pooled", (True, True)),
    "per_draw_lowrank_pooled": ("spiked", dict(init="jitter+adapt_lowrank",
                                               cross_chain_adapt=True, fuse_draws=False),
                                "per_draw_lowrank_pooled", (False, True)),
    "hmc_per_draw_lowrank_pooled": ("spiked", dict(init="jitter+adapt_lowrank",
                                                   cross_chain_adapt=True, fuse_draws=False,
                                                   step="hmc"),
                                    "per_draw_lowrank_pooled", (False, False)),
}


@pytest.mark.parametrize("case", list(ELECTIONS))
def test_election_asks_for_the_jax_probes(case, monkeypatch):
    """``sample()`` asks for the checks where the JAX election probes
    (``fuse_draws=None`` electing fused; a kernel with the pooled
    low-rank metric), recorded here on the CPU, where nothing runs."""
    model, kw, engine, want = ELECTIONS[case]
    kw = dict(kw)
    seen = []
    real = sampling._capability_checks
    monkeypatch.setattr(sampling, "_capability_checks",
                        lambda dev, fa, lk: (seen.append((fa, lk)), real(dev, fa, lk)))
    monkeypatch.setattr(tfp, "check_probe", lambda *a, **k: pytest.fail("probe ran off the card"))
    m = NealsFunnel(10, device="cpu") if model == "funnel" else SpikedGaussian(6, device="cpu")
    n = 10 if model == "funnel" else 6
    if kw.pop("step", None) == "hmc":
        kw["step"] = lt.HamiltonianMC(model_ndim=n)
    rep = {}
    lt.sample(m.logp_grad, model_ndim=n, chains=16, tune=3, draws=2, random_seed=1,
              device="cpu", perf_report=rep, progressbar=False,
              compute_convergence_checks=False, **kw)
    assert rep["engine"] == engine and seen == [want]
