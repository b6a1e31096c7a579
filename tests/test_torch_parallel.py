"""The port's chains split over ranks, held against one process and JAX.

``littlemcmc_torch.parallel`` (``mesh.py``, ``distributed.py``,
``cross_chain.py`` with a ``group``) and ``sample(mesh=, chain_axis=)``:

- the mesh helpers' shapes and errors, in this process;
- a mesh of one rank (an in-process Gloo group) gives the unsharded run's
  bits;
- two processes joined by Gloo over localhost, spawned as
  ``tests/test_multiprocess.py`` spawns its workers, each with a timeout:
  the gathered trace of the per-draw engine on the NUTS and HMC
  trajectory kernels' plain versions (the chain blocks salted with their
  global index, ``block0``) and on the tensor-op tree equals this
  process's unsharded trace bit for bit, and so does pooled ``adapt_full`` on the fused
  engine's plain version, its pooled metric and Welford weight included;
  ``cross_chain_potential_pool`` over the two ranks equals JAX's on the
  whole batch (``tests/test_parallel.py:60-103``) to float32 tolerance and
  the port's unsharded pool bit for bit; the fused diag engine over two
  ranks passes JAX's statistical gates (``tests/test_parallel.py:242-264``).

The ``slow`` test mirrors ``tests/test_multiprocess.py``: pooled
adaptation over two ranks with a checkpoint every 150 draws, and a resume
whose tail is bit-identical.

Each worker imports this module (and so no JAX: the JAX imports sit in
the tests that use them) and runs :func:`run_case` with the same
arguments as this process.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import littlemcmc_torch as lt
from littlemcmc_torch import quadpotential as t_qp
from littlemcmc_torch.models import CorrelatedGaussian, StandardNormal
from littlemcmc_torch.parallel import (chain_mesh, cross_chain_potential_pool,
                                       process_local_chains, shard_chains)
from littlemcmc_torch.parallel.mesh import chain_shard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, CHAINS = 8, 16
POOL_C, POOL_N, POOL_STEPS = 8, 3, 30


def run_case(name: str, mesh=None):
    """``(trace, stats, final_state, perf_report)`` of one case, on the CPU."""
    m = CorrelatedGaussian(N, device="cpu")
    kw = dict(model_ndim=N, chains=CHAINS, tune=50, draws=50, random_seed=3, device="cpu",
              progressbar=False, compute_convergence_checks=False, return_final_state=True)
    if name == "kernel":
        kw["step"] = lt.NUTS(model_ndim=N, chain_block=8)
    elif name == "tree":
        kw["step"] = lt.NUTS(model_ndim=N, trajectory_spec=None, max_treedepth=5,
                             early_max_treedepth=5)
    elif name == "hmc":
        kw["step"] = lt.HamiltonianMC(model_ndim=N, chain_block=8)
    elif name == "pooled_full":
        kw.update(init="jitter+adapt_full", cross_chain_adapt=True,
                  step=lt.NUTS(model_ndim=N, chain_block=8))
    elif name == "fused_diag":
        m = StandardNormal(3, device="cpu")
        kw.update(model_ndim=3, chains=32, tune=100, draws=150, random_seed=13,
                  fuse_draws=True)
    rep = {}
    trace, stats, final = lt.sample(m.logp_grad, mesh=mesh, perf_report=rep, **kw)
    return trace, stats, final, rep


def pool_inputs():
    """Per-chain data for the pools: ``(POOL_STEPS, POOL_C, POOL_N)``."""
    return (np.random.RandomState(0).randn(POOL_STEPS, POOL_C, POOL_N) * 2.0).astype(np.float32)


def torch_pots(kind: str):
    """The port's chain-batched adaptive metric after the pool data."""
    data = torch.from_numpy(pool_inputs())
    zeros = torch.zeros(POOL_C, POOL_N)
    if kind == "diag":
        pot = t_qp.QuadPotentialDiagAdapt.create(zeros, torch.ones(POOL_C, POOL_N),
                                                 initial_weight=0.0)
    else:
        pot = t_qp.QuadPotentialFullAdapt.create(zeros, torch.eye(POOL_N), initial_weight=0.0)
    for x in data:
        pot = pot.update(x, x, True)
    return pot


_WORKER = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, %(repo)r)
from littlemcmc_torch.parallel import (cross_chain_potential_pool, global_chain_mesh,
                                       initialize_distributed, shard_chains)
import tests.test_torch_parallel as T

rank = int(os.environ["LMC_RANK"])  # -1: the one-process run
mesh = group = None
if rank >= 0:
    initialize_distributed("127.0.0.1:%(port)d", 2, rank, backend="gloo", timeout=120)
    mesh = global_chain_mesh()
    group = mesh.get_group("chains")
out = {}
for name in %(cases)r:
    tr, st, fs, rep = T.run_case(name, mesh)
    out[name + "/trace"] = tr
    out[name + "/diverging"] = st["diverging"]
    out[name + "/engine"] = np.array(rep["engine"])
    assert rep["ranks"] == (1 if mesh is None else 2), rep
    assert rep["backend"] == (None if mesh is None else "gloo"), rep
    if name == "pooled_full":
        out[name + "/cov"] = fs.potential.cov.numpy()
        out[name + "/fg_w"] = fs.potential.fg.n_samples.numpy()
for kind in ("diag", "full"):
    pot = T.torch_pots(kind)
    pooled = cross_chain_potential_pool(pot if mesh is None else shard_chains(pot, mesh),
                                        True, group=group)
    out["pool/" + kind] = (pooled.var if kind == "diag" else pooled.cov).numpy()
np.savez(os.path.join(%(out)r, "rank%%d.npz" %% rank), **out)
print("rank %%d OK" %% rank)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(tmp_path, cases, timeout=300):
    """Start the two ranks and the one-process run (rank -1), each on
    PyTorch's scalar CPU kernels (``ATEN_CPU_CAPABILITY=default``): the
    vectorized ones round a batch's last partial vector of a
    transcendental function otherwise than its full ones, so on the CPU a
    row's bits could depend on the batch's length. Returns a function that
    waits for them and returns each one's saved arrays, ranks 0, 1, -1."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER % dict(repo=REPO, port=_free_port(), cases=tuple(cases),
                                     out=str(tmp_path)))
    procs, logs, ranks = [], [], (0, 1, -1)
    for rank in ranks:
        env = dict(os.environ, LMC_RANK=str(rank), OMP_NUM_THREADS="1",
                   ATEN_CPU_CAPABILITY="default")
        env.pop("PYTEST_CURRENT_TEST", None)
        log = open(tmp_path / f"worker{rank}.log", "w+")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, str(script)], env=env, cwd=REPO,
                                      stdout=log, stderr=subprocess.STDOUT))

    def wait():
        try:
            codes = [p.wait(timeout=timeout) for p in procs]
        finally:
            for p in procs:  # a hung rank must not outlive the test
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
            outputs = []
            for log in logs:
                log.seek(0)
                outputs.append(log.read())
                log.close()
        assert codes == [0, 0, 0], "\n".join(outputs)[-4000:]
        return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in ranks]

    return wait


@pytest.fixture
def world_one():
    """A mesh of one rank, and no process group left behind."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_chain_mesh_shapes_and_errors(world_one):
    """``chain_mesh`` raises for more devices than processes before a group
    is up (PyTorch's one device per process), then is a one-rank
    ``chains`` mesh; ``chain_shard`` and ``sample`` refuse a missing
    dimension, and chains that do not split evenly."""
    with pytest.raises(ValueError, match="one process per device"):
        chain_mesh(2)
    mesh = chain_mesh()
    assert mesh.size() == 1 and tuple(mesh.mesh_dim_names) == ("chains",)
    assert chain_mesh(1).size() == 1
    with pytest.raises(ValueError, match=r"chain_mesh\(3\): the process group has 1 rank"):
        chain_mesh(3)
    assert process_local_chains(10) == 10
    shard = chain_shard(mesh, "chains", 16)
    assert (shard.rank, shard.size, shard.local, shard.lo) == (0, 1, 16, 0)
    with pytest.raises(ValueError, match="no dimension named 'devices'"):
        chain_shard(mesh, "devices", 16)
    with pytest.raises(ValueError, match="no dimension named 'devices'"):
        lt.sample(StandardNormal(2, device="cpu").logp_grad, model_ndim=2, chains=4, tune=2,
                  draws=2, device="cpu", progressbar=False, mesh=mesh, chain_axis="devices")

    class TwoRanks:
        mesh_dim_names = ("chains",)

        def size(self, dim=None):
            return 2

    with pytest.raises(ValueError, match=r"chains \(15\) must be divisible"):
        chain_shard(TwoRanks(), "chains", 15)
    x = torch.arange(12.0).reshape(4, 3)
    assert shard_chains((x, {"a": x}), mesh)[1]["a"] is not None
    assert torch.equal(shard_chains(x, mesh), x)


@pytest.mark.parametrize("name", ["kernel", "tree"])
def test_one_rank_mesh_equals_unsharded(name, world_one):
    """``mesh=chain_mesh()`` (one rank) gives ``mesh=None``'s bits."""
    ref = run_case(name)
    got = run_case(name, chain_mesh())
    np.testing.assert_array_equal(got[0], ref[0])
    for k in ref[1]:
        np.testing.assert_array_equal(got[1][k], ref[1][k], err_msg=k)
    assert got[3]["ranks"] == 1 and got[3]["backend"] == "gloo"
    assert ref[3]["ranks"] == 1 and ref[3]["backend"] is None


def _jax_pool(kind: str):
    """JAX's ``cross_chain_potential_pool`` on the pool data, all chains."""
    import jax
    import jax.numpy as jnp

    from littlemcmc_tpu.parallel import cross_chain_potential_pool as j_pool
    from littlemcmc_tpu.quadpotential import QuadPotentialDiagAdapt, QuadPotentialFullAdapt

    if kind == "diag":
        pots = jax.vmap(lambda m: QuadPotentialDiagAdapt.create(
            POOL_N, initial_mean=m, initial_diag=jnp.ones(POOL_N), initial_weight=0.0))(
            jnp.zeros((POOL_C, POOL_N)))
    else:
        pots = jax.vmap(lambda m: QuadPotentialFullAdapt.create(
            POOL_N, initial_mean=m, initial_cov=jnp.eye(POOL_N), initial_weight=0.0))(
            jnp.zeros((POOL_C, POOL_N)))
    tuning = jnp.asarray(True)
    for x in pool_inputs():
        pots = jax.vmap(lambda p, x: p.update(x, x, tuning))(pots, jnp.asarray(x))
    pooled = j_pool(pots, tuning)
    return np.asarray(pooled.var if kind == "diag" else pooled.cov)


def test_two_ranks_over_gloo_equal_one_process(tmp_path):
    """Two Gloo ranks: the per-draw engine on the NUTS and HMC kernels'
    plain versions and on the tree, and pooled ``adapt_full`` on the fused
    engine's plain version, each rank returning the whole trace, equal to
    the one-process run's trace bit for bit; the pooled metric and the
    summed foreground Welford weight (JAX's identity,
    ``tests/test_parallel.py:236-239``) too. The pools over two ranks
    against the one-process pool (bit for bit) and JAX's; the fused diag
    engine's statistics over two ranks."""
    cases = ("kernel", "tree", "hmc", "pooled_full", "fused_diag")
    wait = _spawn(tmp_path, cases)
    jax_pools = {kind: _jax_pool(kind) for kind in ("diag", "full")}
    *ranks, one = wait()

    for name in cases[:4]:
        assert str(one[name + "/engine"]) == ("fused_dense_pooled" if name == "pooled_full"
                                              else "per_draw_diag")
        for r in ranks:
            for k in ("/trace", "/diverging", "/engine"):
                np.testing.assert_array_equal(r[name + k], one[name + k], err_msg=name + k)
    for r in ranks:
        np.testing.assert_array_equal(r["pooled_full/cov"], one["pooled_full/cov"])
        assert float(r["pooled_full/fg_w"].sum()) == float(one["pooled_full/fg_w"].sum())

    for kind in ("diag", "full"):
        got = np.concatenate([ranks[0]["pool/" + kind], ranks[1]["pool/" + kind]])
        np.testing.assert_array_equal(got, one["pool/" + kind])
        np.testing.assert_allclose(got, jax_pools[kind], rtol=1e-5, atol=1e-6)

    tr = ranks[0]["fused_diag/trace"]
    np.testing.assert_array_equal(tr, ranks[1]["fused_diag/trace"])
    assert tr.shape == (32, 150, 3)
    draws = tr.reshape(-1, 3)
    assert abs(draws.mean()) < 0.1
    assert np.all(np.abs(draws.var(0) - 1.0) < 0.25), draws.var(0)
    assert ranks[0]["fused_diag/diverging"].mean() < 0.01
    # the two ranks' chains draw from different streams
    assert not np.allclose(tr[0], tr[16])


_SLOW_WORKER = r"""
import os, shutil, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, %(repo)r)
import littlemcmc_torch as lt
from littlemcmc_torch.models import CorrelatedGaussian
from littlemcmc_torch.parallel import global_chain_mesh, initialize_distributed

rank = int(os.environ["LMC_RANK"])
initialize_distributed("127.0.0.1:%(port)d", 2, rank, backend="gloo", timeout=300)
mesh = global_chain_mesh()
m = CorrelatedGaussian(8, rho=0.5, device="cpu")
kw = dict(logp_dlogp_func=m.logp_grad, model_ndim=8, chains=16, tune=150, draws=300,
          random_seed=11, progressbar=False, device="cpu", mesh=mesh, cross_chain_adapt=True,
          checkpoint_dir=%(ckpt)r, checkpoint_every=150)
trace, stats = lt.sample(**kw)
assert trace.shape == (16, 300, 8)
vr = trace.reshape(-1, 8).var(0) / m.true_var
assert 0.6 < vr.min() and vr.max() < 1.4, vr
acc = stats["mean_tree_accept"].mean()
assert 0.6 < acc < 0.95, acc
names = sorted(os.listdir(os.path.join(%(ckpt)r, "step_00000450")))
assert "state_rank0.pt" in names and "state_rank1.pt" in names, names
# resume from the checkpoint at 300: the last 150 draws again
if rank == 0:
    shutil.rmtree(os.path.join(%(ckpt)r, "step_00000450"))
torch.distributed.barrier()
t_res, _ = lt.sample(resume=True, **kw)
assert t_res.shape[1] == 150, t_res.shape
assert t_res.shape[1] < trace.shape[1]
np.testing.assert_array_equal(t_res, trace[:, -t_res.shape[1]:, :])
print("rank %%d: OK vr=[%%.3f,%%.3f] accept=%%.3f resume tail %%s bit-identical"
      %% (rank, vr.min(), vr.max(), acc, t_res.shape))
"""


@pytest.mark.slow
def test_two_rank_pooled_adaptation_checkpoint_resume(tmp_path):
    """``tests/test_multiprocess.py`` over two Gloo ranks: pooled
    adaptation, one checkpoint file per rank in a shared directory, and a
    resume from the checkpoint at 300 whose 150 draws reproduce the run's
    tail bit for bit."""
    script = tmp_path / "worker.py"
    script.write_text(_SLOW_WORKER % dict(repo=REPO, port=_free_port(),
                                          ckpt=str(tmp_path / "ckpt")))
    procs, logs = [], []
    try:
        for rank in (0, 1):
            env = dict(os.environ, LMC_RANK=str(rank), OMP_NUM_THREADS="1")
            log = open(tmp_path / f"worker{rank}.log", "w+")
            logs.append(log)
            procs.append(subprocess.Popen([sys.executable, str(script)], env=env, cwd=REPO,
                                          stdout=log, stderr=subprocess.STDOUT))
        codes = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        outputs = []
        for log in logs:
            log.seek(0)
            outputs.append(log.read())
            log.close()
    assert codes == [0, 0], "\n".join(outputs)[-4000:]
    assert "rank 0: OK" in outputs[0] and "rank 1: OK" in outputs[1]


def _op_inputs(name, model, C):
    """A kernel op's per-chain and shared inputs and keywords, made with
    numpy from a seed (the smoke's input makers, on the CPU)."""
    import chip_smoke
    from littlemcmc_torch.base import HMCConfig, NUTSConfig

    chol = np.linalg.cholesky(model.cov)
    if name == "hmc_trajectory":
        return (chip_smoke._hmc_inputs(model, chol, C, 0.2, 7), (),
                dict(spec=model.trajectory_spec(), Emax=1000.0, chain_block=4))
    if name == "nuts_trajectory":
        args = chip_smoke._stationary_inputs(model, chol, C, 0.2, 7)
        return args, (), dict(spec=model.trajectory_spec(), max_treedepth=6, Emax=1000.0,
                              chain_block=4)
    args = chip_smoke._fused_inputs(model, C, 7)
    config = (NUTSConfig(max_treedepth=6) if name == "fused_nuts" else HMCConfig())
    return args[:9], args[9:], dict(spec=model.trajectory_spec(), T=3, tuning=True,
                                    config=config, metric="dense", chain_block=4,
                                    dense_welford=chip_smoke._welford_seed(model))


@pytest.mark.parametrize("name", ["nuts_trajectory", "fused_nuts", "hmc_trajectory",
                                  "fused_hmc"])
def test_block0_shard_gives_the_unsharded_rows_on_the_plain_versions(name, monkeypatch):
    """Rows 1-4's plain versions (the dense fused ones in an
    ``adapt_dense`` tune chunk): ``block0=0`` keeps the seed, and the two
    halves of 16 chains in blocks of 4, each launched with its ``block0``
    (and the fused ops' ``welford_blocks``), give the whole launch's rows,
    draws and block Welford states bit for bit, as
    ``tests/test_torch_cuda.py`` holds the kernels."""
    from littlemcmc_torch.ops.fused_hmc import fused_hmc
    from littlemcmc_torch.ops.fused_nuts import fused_nuts
    from littlemcmc_torch.ops.hmc_trajectory import hmc_trajectory
    from littlemcmc_torch.ops.nuts_trajectory import shard_seed, trajectory

    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")  # the input makers' device
    op = {"nuts_trajectory": trajectory, "fused_nuts": fused_nuts,
          "hmc_trajectory": hmc_trajectory, "fused_hmc": fused_hmc}[name]
    C, half = 16, 8
    model = CorrelatedGaussian(N, device="cpu")
    per_chain, shared, kw = _op_inputs(name, model, C)
    cb, fused, seed = kw["chain_block"], name.startswith("fused"), (21, -5)
    assert shard_seed(seed, 0) is seed and shard_seed(5, 0) == 5
    assert shard_seed((2 ** 32 - 1, 9), 2) == ((2 ** 32 - 1 + 2 * 7919) & 0xFFFFFFFF, 9)
    full = op(*per_chain, *shared, seed, **kw)
    for lo in (0, half):
        rows = slice(lo, lo + half)
        extra = dict(welford_blocks=C // cb) if fused else {}
        part = op(*(a[rows] for a in per_chain), *shared, seed, block0=lo // cb, **extra,
                  **kw)
        for k, v in full.items():
            if not isinstance(v, torch.Tensor):
                continue
            if k.startswith("dense_"):  # per block
                want = v[lo // cb:(lo + half) // cb]
            elif v.ndim == 0:
                want = v
            elif fused and v.ndim >= 2 and v.shape[:2] == (kw["T"], C):  # per draw
                want = v[:, rows]
            else:
                want = v[rows]
            assert torch.equal(part[k], want), (k, lo)
