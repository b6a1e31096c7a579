"""The port's trajectory op held against the JAX trajectory kernel.

The JAX kernel ``build_trajectory_op`` runs here under ``interpret=True``,
where it draws from the murmur3 counter stream. The port's plain version
draws the same stream, so the two build the same trees chain for chain:

- ``StandardNormal`` is elementwise and both packages round it alike, so
  every chain must agree (depth, leaves, divergence, turning) and the
  proposal within 1e-5.
- The correlated Gaussian's matvec sums in another order in each package
  (the JAX side here uses a test-local spec with ``precision="highest"``
  in place of the package's bf16x3 split); a rounding difference can flip
  one U-turn or swap decision and, through the block's shared counter,
  the rest of that block. At least 99% of chains must agree.

The CUDA kernel's own tests are in ``test_torch_cuda.py``, which imports
no JAX so that it runs on the machine with the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from littlemcmc_tpu import models as jm
from littlemcmc_tpu.ops import PallasModelSpec, build_trajectory_op
from littlemcmc_tpu.ops.nuts_trajectory_pallas import _fmix32, padded_dim
from littlemcmc_torch import models as tm
from littlemcmc_torch.convert import (chain_state_from_numpy, chain_state_to_numpy,
                                      spec_consts_from_numpy)
from littlemcmc_torch.ops import TrajectorySpec, trajectory
from littlemcmc_torch.ops.nuts_trajectory import counter_salt, counter_uniform, fmix32

torch.set_num_threads(1)

FLAGS = ("depth", "n_leaves", "diverging", "turning")


def test_fmix32_bit_for_bit():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.integers(0, 2 ** 32, 4096, dtype=np.uint64),
                        [0, 1, 2 ** 31, 2 ** 32 - 1]]).astype(np.uint32)
    want = np.asarray(_fmix32(jnp.asarray(x)))
    got = fmix32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed0,seed1,block", [(3, 3, 0), (2 ** 31 - 5, -7, 9),
                                               (-2 ** 31, 2 ** 31 - 1, 127)])
def test_counter_uniform_bit_for_bit(seed0, seed1, block):
    """The stream of ``_make_counter_uniform`` (nuts_trajectory_pallas.py:
    347-369) for pack 1, written out in jnp: int32 wrap of the base and
    lane offsets, uint32 products in the hash."""
    rows, calls = 8, 40
    base = jnp.int32(seed0) + jnp.int32(block) * jnp.int32(7919)
    lane = jnp.arange(rows, dtype=jnp.int32)
    s1u = jnp.asarray(seed1, jnp.int32).astype(jnp.uint32) * jnp.uint32(0x9E3779B9)
    salt = _fmix32((base + lane * 101027).astype(jnp.uint32) ^ s1u)
    c = jnp.arange(1, calls + 1, dtype=jnp.int32)[:, None].astype(jnp.uint32)
    x = _fmix32(salt[None, :] ^ (c * jnp.uint32(0x9E3779B9)))
    want = np.asarray(((x >> jnp.uint32(8)).astype(jnp.int32).astype(jnp.float32) + 0.5)
                      * (1.0 / (1 << 24)))
    t_salt = counter_salt(seed0, seed1, block, rows)
    got = counter_uniform(t_salt[None, :], torch.arange(1, calls + 1)[:, None]).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(counter_uniform(t_salt, 5).numpy(), want[4])


class _CorrelatedHighest:
    """The JAX correlated Gaussian with its kernel body in full float32."""

    def __init__(self, n):
        self.model = jm.CorrelatedGaussian(n)
        prec = np.zeros((padded_dim(n),) * 2, np.float32)
        prec[:n, :n] = self.model.prec.astype(np.float32)

        def fn(q, p):
            g = -jnp.dot(q, p, precision="highest", preferred_element_type=jnp.float32)
            return 0.5 * jnp.sum(q * g, axis=1, keepdims=True), g

        self.spec = PallasModelSpec(fn, (jnp.asarray(prec),), n)


def _inputs(n, C, cov_chol, var_scale, eps, seed):
    """Stationary (q, p) for a Gaussian with covariance chol @ chol.T and
    the inverse-mass diagonal ``var_scale * U(0.5, 2)``."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((C, n)) @ cov_chol.T).astype(np.float32)
    var = (var_scale * rng.uniform(0.5, 2.0, (C, n))).astype(np.float32)
    p = (rng.standard_normal((C, n)) / np.sqrt(var)).astype(np.float32)
    eps = np.full(C, eps, np.float32) * rng.uniform(0.8, 1.2, C).astype(np.float32)
    return q, p, var, eps


def _compare(j_spec, jfn, t_spec, n, C, D, CB, q, p, var, eps, seed,
             integrator="leapfrog"):
    lp, g = (np.asarray(x) for x in jax.vmap(jfn)(jnp.asarray(q)))
    mdc = np.full(C, D, np.int32)
    mdc[::5] = D - 2  # some chains carry the early tree-depth cap
    op = build_trajectory_op(j_spec, n, D, 1000.0, integrator, interpret=True,
                             chain_block=CB)
    want = jax.tree.map(np.asarray, op(q, p, g, lp, eps, mdc, var,
                                       jnp.asarray(seed, jnp.int32)))
    t = {k: torch.from_numpy(np.array(v)) for k, v in
         dict(q=q, p=p, grad=g, logp=lp, eps=eps, mdc=mdc, var=var).items()}
    launches = trajectory.launches
    got = trajectory(t["q"], t["p"], t["grad"], t["logp"], t["eps"], t["mdc"],
                     t["var"], seed, spec=t_spec, max_treedepth=D, Emax=1000.0,
                     chain_block=CB, integrator=integrator)
    assert trajectory.launches == launches  # the CPU runs the plain version
    got = {k: v.numpy() for k, v in got.items()}
    agree = np.all([got[k] == want[k] for k in FLAGS], axis=0)
    return got, want, agree


@pytest.mark.parametrize("integrator", ["leapfrog", "three_stage"])
def test_plain_matches_jax_kernel_standard_normal(integrator):
    n, C, D, CB = 4, 128, 6, 8
    q, p, var, eps = _inputs(n, C, np.eye(n), 1.0, 0.5, seed=1)
    got, want, agree = _compare(jm.StandardNormal(n).pallas_trajectory_spec(),
                                jm.StandardNormal(n).logp_grad,
                                tm.StandardNormal(n, device="cpu").trajectory_spec(),
                                n, C, D, CB, q, p, var, eps, (7, 11), integrator)
    assert agree.all()
    assert want["depth"].mean() > 2  # real trees, not single leaves
    np.testing.assert_allclose(got["q"], want["q"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["grad"], want["grad"], atol=1e-5, rtol=0)
    for k in ("energy", "logp", "log_size", "max_energy_change"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-5)


def test_plain_matches_jax_kernel_correlated_gaussian():
    n, C, D, CB = 20, 256, 8, 8
    jmodel = _CorrelatedHighest(n)
    consts = spec_consts_from_numpy([np.asarray(c) for c in jmodel.spec.consts], n)
    t_spec = TrajectorySpec("correlated_gaussian", consts, n)
    torch.testing.assert_close(consts[0], torch.from_numpy(
        jmodel.model.prec.astype(np.float32)), rtol=0, atol=0)
    q, p, var, eps = _inputs(n, C, np.linalg.cholesky(jmodel.model.cov),
                             jmodel.model.true_var, 0.25, seed=2)
    got, want, agree = _compare(jmodel.spec, jmodel.model.logp_grad, t_spec,
                                n, C, D, CB, q, p, var, eps, (3, -5))
    assert agree.mean() >= 0.99, agree.mean()
    assert want["depth"].mean() > 2
    # proposals of agreeing chains: 1e-5 of the posterior scale
    scale = np.sqrt(jmodel.model.true_var)
    np.testing.assert_allclose(got["q"][agree] / scale, want["q"][agree] / scale,
                               atol=1e-5, rtol=0)


def test_trajectory_checks_its_inputs():
    spec = tm.StandardNormal(3, device="cpu").trajectory_spec()
    C = 8
    f = torch.zeros(C, 3)
    args = [f, f, f, torch.zeros(C), torch.full((C,), 0.1),
            torch.full((C,), 4, dtype=torch.int32), torch.ones(C, 3)]
    kw = dict(spec=spec, max_treedepth=4, Emax=1000.0)
    trajectory(*args, 1, **kw)
    bad = list(args)
    bad[5] = bad[5].to(torch.int64)
    with pytest.raises(ValueError, match="max_depth_c"):
        trajectory(*bad, 1, **kw)
    bad = list(args)
    bad[0] = torch.zeros(C, 4)
    with pytest.raises(ValueError, match="columns"):
        trajectory(*bad, 1, **kw)


def _jax_state_numpy(C, n, seed):
    """A chain-batched JAX ChainState a few adaptation steps in, as the
    named numpy leaves ``convert`` takes."""
    from littlemcmc_tpu.base import NUTSConfig, init_chain_state
    from littlemcmc_tpu.quadpotential import QuadPotentialDiagAdapt
    from littlemcmc_tpu.step_sizes import dual_average_update

    model = jm.StandardNormal(n)
    rng = np.random.default_rng(seed)
    q0 = jnp.asarray(rng.standard_normal((C, n)), jnp.float32)

    def init(k, q):
        pot = QuadPotentialDiagAdapt.create(n, initial_mean=q, initial_diag=jnp.ones(n),
                                            initial_weight=10.0)
        s = init_chain_state(k, q, pot, NUTSConfig(), model.logp_grad)
        for i in range(3):
            s = s.replace(potential=s.potential.update(q * (i + 2.0), q, True),
                          da=dual_average_update(s.da, 0.5 + 0.1 * i, True, target=0.8,
                                                 gamma=0.05, k=0.75, t0=10.0))
        return s

    state = jax.jit(jax.vmap(init))(jax.random.split(jax.random.key(seed), C), q0)
    leaves = jax.tree_util.tree_flatten_with_path(state)[0]
    return {".".join(k.name for k in path): np.asarray(v) for path, v in leaves
            if path[0].name != "rng_key"}


def test_convert_round_trip_and_shared_start():
    d = _jax_state_numpy(C=16, n=5, seed=4)
    state = chain_state_from_numpy(d, device="cpu")
    back = chain_state_to_numpy(state)
    assert back.keys() == d.keys()
    for k in d:
        assert back[k].dtype == d[k].dtype, k
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)
    assert state.q.shape == (16, 5) and state.potential.fg.w_sum.shape == (16,)
    # from one state, both packages take the same next adaptation step
    from littlemcmc_tpu.quadpotential import QuadPotentialDiagAdapt as JPot
    from littlemcmc_tpu.quadpotential import WelfordVariance as JW

    def jw(side):
        return JW(*(jnp.asarray(d[f"potential.{side}.{k}"])
                    for k in ("w_sum", "w_sum2", "mean", "raw_var")))

    jpot = JPot(var=jnp.asarray(d["potential.var"]), stds=jnp.asarray(d["potential.stds"]),
                inv_stds=jnp.asarray(d["potential.inv_stds"]), fg=jw("fg"), bg=jw("bg"),
                n_samples=jnp.asarray(d["potential.n_samples"]),
                window=jnp.asarray(d["potential.window"]))
    x = np.random.default_rng(5).standard_normal((16, 5)).astype(np.float32)
    want = jax.vmap(lambda p, s: p.update(s, s, True))(jpot, jnp.asarray(x))
    got = state.potential.update(torch.from_numpy(x), None, True)
    np.testing.assert_allclose(got.var.numpy(), np.asarray(want.var), rtol=1e-6)



@pytest.mark.parametrize("chain_block", [1, 8, 16])
def test_block_transition_predicate_matches_the_kernels(chain_block):
    """``runs_block_transition`` names the instances that ``block_body()``
    and ``kBlockChains`` of ``csrc/nuts_transition.cuh`` put on the block
    transition: bodies 0, 1, 2, 4 and 5 with the diagonal metric, body 1
    with the dense metric and body 4 with the low-rank metric, in blocks of
    up to 8 chains."""
    import re
    from pathlib import Path

    from littlemcmc_torch.ops.nuts_trajectory import (BLOCK_TRANSITION_BODIES,
                                                      BLOCK_TRANSITION_CHAINS,
                                                      BLOCK_TRANSITION_DENSE_BODIES,
                                                      BLOCK_TRANSITION_LOWRANK_BODIES, BODY_IDS,
                                                      METRIC_IDS, runs_block_transition)

    src = (Path(__file__).resolve().parents[1] / "littlemcmc_torch" / "ops" / "csrc"
           / "nuts_transition.cuh").read_text()
    fn = re.search(r"constexpr bool block_body\(\) \{\s*return (.*?);", src, re.S).group(1)
    # one (bodies && METRIC == kX) term a metric, joined by ||
    terms = re.findall(r"\(+([^&]*?)\)?\s*&&\s*METRIC == (k\w+)\)", fn)
    assert [m for _, m in terms] == ["kDiag", "kDense", "kLowRank"]
    names = {"kDiag": "diag", "kDense": "dense", "kLowRank": "lowrank"}
    bodies = {METRIC_IDS[names[m]]: {int(b) for b in re.findall(r"BODY == (\d+)", t)}
              for t, m in terms}
    chains = int(re.search(r"constexpr int kBlockChains = (\d+);", src).group(1))
    assert ({BODY_IDS[b] for b in BLOCK_TRANSITION_BODIES} == bodies[METRIC_IDS["diag"]]
            == {0, 1, 2, 4, 5})
    assert {BODY_IDS[b] for b in BLOCK_TRANSITION_DENSE_BODIES} == bodies[METRIC_IDS["dense"]]
    assert bodies[METRIC_IDS["dense"]] == {1}
    assert ({BODY_IDS[b] for b in BLOCK_TRANSITION_LOWRANK_BODIES}
            == bodies[METRIC_IDS["lowrank"]] == {4})
    assert BLOCK_TRANSITION_CHAINS == chains
    for body, bid in BODY_IDS.items():
        for metric, mid in METRIC_IDS.items():
            want = bid in bodies.get(mid, set()) and chain_block <= chains
            assert runs_block_transition(body, metric, chain_block) == want


@pytest.mark.parametrize("body,metric,chain_block,vecs", [
    ("correlated_gaussian", "dense", 8, 6),
    ("correlated_gaussian", "dense", 1, 6),
    ("correlated_gaussian", "dense", 16, 4),
    ("correlated_gaussian", "diag", 8, 4),
    ("eight_schools", "diag", 8, 4),
    ("spiked_gaussian", "dense", 8, 4),
    ("logistic", "dense", 8, 4),
    ("spiked_gaussian", "lowrank", 8, 6),
    ("spiked_gaussian", "lowrank", 1, 6),
    ("correlated_gaussian", "lowrank", 8, 4),
])
def test_stack_shape_by_metric_and_instance(body, metric, chain_block, vecs):
    """The global merge stack holds the velocities of a slot's edges (6
    vectors a slot, ``slot_vecs`` of ``csrc/nuts_transition.cuh``) only
    where the dense or the low-rank metric runs the block transition; every
    other instance (body 1 with the low-rank metric among them), and blocks
    of more than 8 chains, keep 4."""
    import re
    from pathlib import Path

    from littlemcmc_torch.ops.nuts_trajectory import stack_shape

    src = (Path(__file__).resolve().parents[1] / "littlemcmc_torch" / "ops" / "csrc"
           / "nuts_transition.cuh").read_text()
    fn = re.search(r"constexpr int slot_vecs\(\) \{\s*return (.*?);", src, re.S).group(1)
    assert fn == "METRIC == kDiag ? 4 : 6"
    assert stack_shape(body, metric, chain_block, 10, 1024, 100) == (vecs, 10, 1024, 100)
