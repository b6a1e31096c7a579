"""The port's symplectic integrator (``littlemcmc_torch.integration``)
against the JAX package's on the CPU: the reversibility grid of
``tests/test_integration.py:23-102`` (n steps forward, n steps with -eps,
back at the start), each chain of a batch against the JAX integrator's
single chain at the same ``(q, p)``, and the energy's definition.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from littlemcmc_tpu.integration import compute_state as j_compute_state
from littlemcmc_tpu.integration import leapfrog as j_leapfrog
from littlemcmc_tpu.quadpotential import QuadPotentialDiag as JDiag
from littlemcmc_torch.integration import compute_state, leapfrog
from littlemcmc_torch.quadpotential import QuadPotentialDiag

C, NDIM = 3, 5


def _logp_grad(q):
    return -0.5 * (q * q).sum(-1), -q


def _j_logp_grad(q):
    return -0.5 * jnp.sum(q ** 2), -q


def _start(seed=42):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((C, NDIM)).astype(np.float32),
            rng.standard_normal((C, NDIM)).astype(np.float32))


@pytest.mark.parametrize("scheme", ["leapfrog", "two_stage", "three_stage"])
@pytest.mark.parametrize("epsilon", [0.01, 0.1])
@pytest.mark.parametrize("n_steps", [1, 2, 3, 4, 20])
def test_integrator_reversible_and_matches_jax(scheme, epsilon, n_steps):
    q, p = _start()
    pot = QuadPotentialDiag.create(torch.full((NDIM,), 0.7)).broadcast(C)
    state = compute_state(pot, _logp_grad, torch.from_numpy(q), torch.from_numpy(p))
    eps = torch.full((C,), epsilon)
    fwd = state
    for _ in range(n_steps):
        fwd = leapfrog(pot, _logp_grad, eps, fwd, scheme)
    back = fwd
    for _ in range(n_steps):
        back = leapfrog(pot, _logp_grad, -eps, back, scheme)
    np.testing.assert_allclose(back.q.numpy(), q, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(back.p.numpy(), p, rtol=1e-4, atol=1e-5)

    jpot = JDiag.create(jnp.full((NDIM,), 0.7))
    for c in range(C):
        js = j_compute_state(jpot, _j_logp_grad, jnp.asarray(q[c]), jnp.asarray(p[c]))
        for _ in range(n_steps):
            js = j_leapfrog(jpot, _j_logp_grad, jnp.asarray(epsilon, jnp.float32), js, scheme)
        for name in ("q", "p", "v", "q_grad"):
            np.testing.assert_allclose(getattr(fwd, name)[c].numpy(),
                                       np.asarray(getattr(js, name)), rtol=1e-5, atol=1e-6,
                                       err_msg=name)
        np.testing.assert_allclose(float(fwd.energy[c]), float(js.energy), rtol=1e-5,
                                   atol=1e-5)


def test_energy_definition_matches_jax():
    q = np.array([[0.5, -1.0, 2.0]], np.float32)
    p = np.array([[1.0, 0.0, -0.5]], np.float32)
    var = np.array([0.5, 1.0, 2.0], np.float32)
    state = compute_state(QuadPotentialDiag.create(torch.from_numpy(var)).broadcast(1),
                          _logp_grad, torch.from_numpy(q), torch.from_numpy(p))
    js = j_compute_state(JDiag.create(jnp.asarray(var)), _j_logp_grad, jnp.asarray(q[0]),
                         jnp.asarray(p[0]))
    logp = -0.5 * float((q ** 2).sum())
    np.testing.assert_allclose(float(state.energy[0]), 0.5 * float((var * p ** 2).sum()) - logp,
                               rtol=1e-6)
    np.testing.assert_allclose(float(state.energy[0]), float(js.energy), rtol=1e-6)
    np.testing.assert_allclose(state.v[0].numpy(), np.asarray(js.v), rtol=1e-6)
    assert jax.numpy.isfinite(js.energy)
