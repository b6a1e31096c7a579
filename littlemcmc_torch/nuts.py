"""NUTS transitions, batched over chains: the tensor-op tree and the kernel paths.

Counterpart of ``littlemcmc_tpu/nuts.py``:

- :func:`run_nuts_tree` (``:461-628``), the tree built from separate
  tensor ops with the model called as a function: the engine for a model
  without a kernel body (a plain closure, a numpy callable, a batched
  model kernel such as the logistic one), and for metrics the kernels do
  not take (per-chain dense and low-rank adaptation,
  ``QuadPotentialFullInv``). It
  keeps the JAX code's structure (``nuts.py:1-47``): one scalar schedule
  for every chain (depth, leaf index, merge count, stack height), the
  merge stack ``_build_subtree`` replaying the reference's recursion, and
  per-chain masks for the chains that stopped. Each ``jnp.any`` of a JAX
  ``while_loop`` condition is one host read here (``bool(mask.any())``):
  one per doubling, one per leaf and one per merge. Those reads, and the
  about 80 PyTorch launches of a leaf, set how host-bound this engine is;
- :func:`build_nuts_kernel` (``:682-917``), the per-draw engine: fresh
  momentum, the step size from dual averaging, the early tree-depth cap,
  then either one trajectory-kernel launch for all chains (diag metrics,
  a static dense metric, a pooled adaptive dense metric,
  ``_shared_dense_cov`` ``:642-659``, or the pooled low-rank metric,
  ``_shared_lowrank_factor`` ``:662-680``) or :func:`run_nuts_tree` with the
  proposal's gradient recomputed once, then the dual-averaging and
  metric updates;
- :func:`build_fused_nuts_runner_factory` (``:1006-1326``), the fused
  engine: one fused-op launch per chunk of draws, for a static or an
  adaptive diagonal metric, per chain or pooled at chunk boundaries
  (``diag_static``, ``diag_adapt``, the pooled diag of ``:1259-1271``), a
  static dense metric, the pooled dense metric refreshed at chunk
  boundaries (``_pool_dense_welford`` ``:927-950``,
  ``_dense_boundary_potential`` ``:967-1003``), or the pooled low-rank
  metric: its variances adapted per chain in the kernel, its factor frozen
  for a chunk and refreshed at tune chunks' boundaries (``:1053-1135``,
  ``:1228-1250``).

The tree's random calls (the key splits ``_split_each`` ``:140``, the
direction's Bernoulli ``:491`` and ``_logbern_b`` ``:146``) go through one
object, a *tree random source*: :class:`GeneratorTreeRandom` draws from a
``torch.Generator`` (Philox on the card) with opaque placeholder keys; a
test can pass one that wraps ``jax.random`` with threefry keys, so the
port's tree and the JAX package's build the same trees chain for chain.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from .base import BatchedLogpGrad, ChainState, NUTSConfig, finish_step, pooled_tune_schedule
from .integration import INTEGRATOR_COEFFS
from .math import log1mexp
from .ops.fused_nuts import WELFORD_KEYS, combine_dense_welford, fused_nuts
from .ops.nuts_trajectory import (DEFAULT_CHAIN_BLOCK, TrajectorySpec, _rowdot,
                                  build_lowrank_fac, resolve_chain_block, trajectory)
from .parallel.cross_chain import cross_chain_potential_pool, lowrank_boundary_refresh
from .parallel.distributed import all_any, gather_chains, gather_tree, group_rank_size
from .quadpotential import (QuadPotentialDiag, QuadPotentialDiagAdapt, QuadPotentialFull,
                            QuadPotentialFullAdapt, QuadPotentialLowRankAdapt,
                            WelfordCovariance, cholesky_or_keep)
from .step_sizes import DualAverageState
from .streams import torch_generator, tree_random

__all__ = ["NUTSInfo", "PhaseState", "TreeNode", "TreeResult", "GeneratorTreeRandom",
           "run_nuts_tree", "build_nuts_kernel", "build_fused_nuts_runner_factory"]

_NO_SPEC = ("the fused NUTS kernel inlines a model body: it needs a model with a "
            "trajectory_spec() (StandardNormal, CorrelatedGaussian, SpikedGaussian, "
            "EightSchools, LogisticRegression); other models run on the per-draw engine's "
            "tensor-op tree (run_nuts_tree)")


class NUTSInfo(NamedTuple):
    """Per-draw sampler stats, ``(C,)`` each (reference ``nuts.py:87-101``)."""

    depth: torch.Tensor
    step_size: torch.Tensor
    tune: torch.Tensor
    mean_tree_accept: torch.Tensor
    step_size_bar: torch.Tensor
    tree_size: torch.Tensor
    diverging: torch.Tensor
    energy_error: torch.Tensor
    energy: torch.Tensor
    max_energy_error: torch.Tensor
    model_logp: torch.Tensor
    reached_max_treedepth: torch.Tensor


# --------------------------------------------------------------------------
# The tensor-op tree
# --------------------------------------------------------------------------

class PhaseState(NamedTuple):
    """Slim phase-space point of the tree's hot loop, ``(C, ...)`` each;
    no velocity (recomputed from ``p`` where needed; reference
    ``nuts.py:68-79``)."""

    q: torch.Tensor
    p: torch.Tensor
    q_grad: torch.Tensor
    energy: torch.Tensor
    logp: torch.Tensor


class TreeNode(NamedTuple):
    """A completed subtree, boundaries in integration order, ``(C, ...)``
    each (reference ``nuts.py:82-104``): the momenta at its two ends, their
    velocities for a dense metric (None for a diagonal one, recomputed at
    the checks), the momentum sum and the multinomial proposal."""

    left_p: torch.Tensor
    right_p: torch.Tensor
    left_v: Optional[torch.Tensor]
    right_v: Optional[torch.Tensor]
    p_sum: torch.Tensor
    q: torch.Tensor
    energy: torch.Tensor
    logp: torch.Tensor
    log_size: torch.Tensor
    log_weighted_accept_sum: torch.Tensor


class TreeResult(NamedTuple):
    """One trajectory's proposal and stats, ``(C,)`` each but ``prop_q``
    (reference ``nuts.py:448-458``)."""

    prop_q: torch.Tensor
    prop_energy: torch.Tensor
    prop_logp: torch.Tensor
    depth: torch.Tensor
    n_proposals: torch.Tensor
    mean_tree_accept: torch.Tensor
    max_energy_change: torch.Tensor
    diverging: torch.Tensor
    turning: torch.Tensor
    reached_max_treedepth: torch.Tensor


class GeneratorTreeRandom:
    """The tree's random source on a ``torch.Generator``: every call draws
    fresh numbers for all ``chains`` on ``device``. Its keys are
    placeholders (None); a split gives placeholders and a masked select
    the first. A random source has four methods: ``split(keys, num)``
    (a tuple of ``num`` key batches), ``where(mask, a, b)`` (per chain),
    ``bernoulli(keys)`` (a fair coin per chain, bool ``(C,)``) and
    ``uniform(keys)`` (U(0, 1) per chain, float32 ``(C,)``), and may have
    ``any(mask)``, which the tree's loops ask whether any chain goes on.

    Under a mesh (``shard``, a
    :class:`~littlemcmc_torch.parallel.mesh.ChainShard`) each call draws
    for the whole chain batch and keeps this rank's rows, and ``any`` asks
    every rank, so each rank's tree draws what the unsharded tree draws."""

    def __init__(self, generator: torch.Generator, chains: int, device, shard=None):
        self.generator, self.chains, self.device = generator, chains, device
        self.shard = shard

    def split(self, keys, num: int):
        return (None,) * num

    def where(self, mask, a, b):
        return a

    def bernoulli(self, keys) -> torch.Tensor:
        return self.uniform(keys) < 0.5

    def uniform(self, keys) -> torch.Tensor:
        if self.shard is None:
            return torch.rand(self.chains, generator=self.generator, device=self.device)
        return self.shard.rows(torch.rand(self.shard.chains, generator=self.generator,
                                          device=self.device))

    def any(self, mask: torch.Tensor) -> bool:
        if self.shard is None:
            return bool(mask.any())
        return all_any(mask, self.shard.group)


def _any(rng, mask: torch.Tensor) -> bool:
    """Whether any chain of ``mask`` goes on: one host read (the random
    source's ``any`` where it has one, which may ask every rank)."""
    ask = getattr(rng, "any", None)
    return bool(mask.any()) if ask is None else ask(mask)


def _mwhere(mask: torch.Tensor, a, b):
    """``where`` over every field of two NamedTuples with a ``(C,)`` mask."""
    def sel(x, y):
        return torch.where(mask.reshape(mask.shape + (1,) * (x.ndim - 1)), x, y)

    return type(a)(*(sel(x, y) for x, y in zip(a, b)))


def _logbern_b(rng, keys, log_p: torch.Tensor) -> torch.Tensor:
    """Per-chain Bernoulli in log space; NaN ``log_p`` gives False
    (reference ``nuts.py:146-149``)."""
    return torch.log(rng.uniform(keys)) < log_p


def _leaf_node(state: PhaseState, energy_change: torch.Tensor,
               v: Optional[torch.Tensor] = None) -> TreeNode:
    """Single-leapfrog subtree (reference ``_single_step``, ``nuts.py:359-368``):
    log size ``-dE``, log weighted accept ``-dE + min(0, -dE)``."""
    log_size = -energy_change
    return TreeNode(left_p=state.p, right_p=state.p, left_v=v, right_v=v, p_sum=state.p,
                    q=state.q, energy=state.energy, logp=state.logp, log_size=log_size,
                    log_weighted_accept_sum=log_size + torch.clamp(log_size, max=0.0))


def _make_batched_potential_ops(potential):
    """``(velocity_b, kinetic_b)`` of a chain-batched metric: its own
    batched methods (the JAX package vmaps a per-chain pytree)."""
    return potential.velocity, potential.kinetic


def _diag_inverse_mass(potential) -> Optional[torch.Tensor]:
    """The ``(C, n)`` inverse-mass diagonal of a diagonal metric, or None."""
    if isinstance(potential, (QuadPotentialDiag, QuadPotentialDiagAdapt)):
        return potential.inverse_mass
    return None


def _leapfrog_b(velocity_b, kinetic_b, logp_grad_b: BatchedLogpGrad, epsilon: torch.Tensor,
                state: PhaseState, scheme: str = "leapfrog"
                ) -> Tuple[PhaseState, torch.Tensor]:
    """Batched symplectic step (reference ``nuts.py:185-206``); also
    returns the final velocity, which a dense metric's caller stores."""
    b, a = INTEGRATOR_COEFFS[scheme]
    eps = epsilon[:, None]
    p = state.p + (b[0] * eps) * state.q_grad
    q, logp, grad = state.q, state.logp, state.q_grad
    for i, ai in enumerate(a):
        v = velocity_b(p)
        q = q + (ai * eps) * v
        logp, grad = logp_grad_b(q)
        p = p + (b[i + 1] * eps) * grad
    v = velocity_b(p)
    kin = kinetic_b(p, v)
    return PhaseState(q, p, grad, kin - logp, logp), v


def _merge_nodes(rng, keys, t1: TreeNode, t2: TreeNode, check_extra: bool,
                 velocity_b) -> Tuple[TreeNode, torch.Tensor]:
    """Merge two adjacent complete subtrees, ``t1`` then ``t2`` in
    integration order (reference ``nuts.py:209-256``): the full-span
    U-turn check, the two cross-subtree checks when both children have
    depth >= 1 (``check_extra``), the log-space weights and the
    multinomial proposal swap. Returns the node and the per-chain
    ``turning``."""
    if t1.left_v is not None:
        v_1l, v_1r, v_2l, v_2r = t1.left_v, t1.right_v, t2.left_v, t2.right_v
    else:
        v_1l, v_1r = velocity_b(t1.left_p), velocity_b(t1.right_p)
        v_2l, v_2r = velocity_b(t2.left_p), velocity_b(t2.right_p)

    p_sum = t1.p_sum + t2.p_sum
    turning = (_rowdot(p_sum, v_1l) <= 0) | (_rowdot(p_sum, v_2r) <= 0)
    if check_extra:
        p_sum1 = t1.p_sum + t2.left_p
        turning1 = (_rowdot(p_sum1, v_1l) <= 0) | (_rowdot(p_sum1, v_2l) <= 0)
        p_sum2 = t1.right_p + t2.p_sum
        turning2 = (_rowdot(p_sum2, v_1r) <= 0) | (_rowdot(p_sum2, v_2r) <= 0)
        turning = turning | turning1 | turning2

    # torch's fused logaddexp: within an ulp of jnp.logaddexp's formula
    # (which the kernels' plain versions keep), at a tenth of its launches
    log_size = torch.logaddexp(t1.log_size, t2.log_size)
    lwas = torch.logaddexp(t1.log_weighted_accept_sum, t2.log_weighted_accept_sum)
    take2 = _logbern_b(rng, keys, t2.log_size - log_size)
    node = TreeNode(
        left_p=t1.left_p, right_p=t2.right_p, left_v=t1.left_v, right_v=t2.right_v,
        p_sum=p_sum, q=torch.where(take2[:, None], t2.q, t1.q),
        energy=torch.where(take2, t2.energy, t1.energy),
        logp=torch.where(take2, t2.logp, t1.logp),
        log_size=log_size, log_weighted_accept_sum=lwas)
    return node, turning


class _SubtreeResult(NamedTuple):
    node: TreeNode
    end_state: PhaseState
    n_leaves: torch.Tensor
    max_energy_change: torch.Tensor
    diverging: torch.Tensor
    turning: torch.Tensor


def _push(stack: TreeNode, node: TreeNode, h: int) -> None:
    """Write ``node`` into slot ``h`` of the merge stack, in place."""
    for s, x in zip(stack, node):
        if s is not None:
            s[h] = x


def _peek(stack: TreeNode, h: int) -> TreeNode:
    """Slot ``h`` of the merge stack (views)."""
    return TreeNode(*(None if s is None else s[h] for s in stack))


def _build_subtree(rng, keys, edge: PhaseState, depth: int, epsilon: torch.Tensor,
                   active: torch.Tensor, start_energy: torch.Tensor,
                   max_energy_change0: torch.Tensor, stack: TreeNode, velocity_b, kinetic_b,
                   logp_grad_b: BatchedLogpGrad, config: NUTSConfig,
                   store_velocity: bool = False) -> _SubtreeResult:
    """Build a complete subtree of ``2**depth`` leapfrogs from ``edge``:
    the merge-stack replay of the reference's ``_build_subtree``
    (reference ``nuts.py:282-425``). ``depth``, the leaf index and the
    stack height are scalars shared by every chain; ``active`` and
    ``building`` mask the chains that stopped. ``stack`` is the caller's
    scratch, written in place (no slot is read before it is written).

    Aborted (non-building) chains are not frozen: they integrate on, and
    every consumer of their values is masked, as in the JAX code."""
    n_total = 1 << depth
    C = edge.q.shape[0]
    dev = edge.q.device
    leaf_idx, height = 0, 0
    cur, building = edge, active
    n_leaves = torch.zeros(C, dtype=torch.int32, device=dev)
    mec = max_energy_change0
    diverging = torch.zeros(C, dtype=torch.bool, device=dev)
    turning = torch.zeros_like(diverging)
    # host read: one per leaf (the JAX loop's jnp.any(c.building))
    while leaf_idx < n_total and _any(rng, building):
        cur, v_new = _leapfrog_b(velocity_b, kinetic_b, logp_grad_b, epsilon, cur,
                                 config.integrator)
        inf = float("inf")
        energy_change = torch.nan_to_num(cur.energy - start_energy, nan=inf, posinf=inf,
                                         neginf=-inf)
        abs_change = energy_change.abs()
        mec = torch.where(building & (abs_change > mec.abs()), energy_change, mec)
        div_leaf = building & (abs_change >= config.Emax)  # NaN counted as infinite
        n_leaves = n_leaves + building
        node = _leaf_node(cur, energy_change, v_new if store_velocity else None)

        # one merge per trailing one-bit of leaf_idx: the internal nodes the
        # reference's recursion completes after this leaf; chains that
        # diverged here or turned at an earlier merge stop applying them
        merging0 = building & ~div_leaf
        merging, j, h = merging0, 0, height
        # host read: one per merge (the JAX merge loop's jnp.any(merging_))
        while (leaf_idx >> j) & 1 and _any(rng, merging):
            keys, k_merge = rng.split(keys, 2)
            node, turning_new = _merge_nodes(rng, k_merge, _peek(stack, h - 1), node,
                                             j >= 1, velocity_b)
            merging = merging & ~turning_new
            j, h = j + 1, h - 1
        turned = merging0 & ~merging

        # building & ~div_leaf & ~turned: the chains still merging
        building = merging
        _push(stack, node, h)
        leaf_idx, height = leaf_idx + 1, h + 1
        diverging = diverging | div_leaf
        turning = turning | turned

    # a clean completion leaves one frame on the stack, slot 0
    return _SubtreeResult(node=_peek(stack, 0), end_state=cur, n_leaves=n_leaves,
                          max_energy_change=mec, diverging=diverging, turning=turning)


def run_nuts_tree(rng, keys, start: PhaseState, step_size: torch.Tensor,
                  max_depth_c: torch.Tensor, potential, logp_grad_b: BatchedLogpGrad,
                  config: NUTSConfig) -> TreeResult:
    """One NUTS trajectory for every chain: iterative tree doubling
    (reference ``run_nuts_tree``, ``nuts.py:461-628``; ``NUTS._hamiltonian_step``
    and ``_Tree.extend``, reference ``nuts.py:204-224, 284-342``).

    ``rng``/``keys``: the random source and its keys (``None`` for
    :class:`GeneratorTreeRandom`). ``max_depth_c`` is per chain; the scalar
    loop runs to the largest. Diagonal metrics recompute boundary
    velocities at the checks; other metrics store them in the nodes."""
    velocity_b, kinetic_b = _make_batched_potential_ops(potential)
    C = start.q.shape[0]
    dtype, dev = start.energy.dtype, start.q.device
    # host read, once a trajectory; an early cap above max_treedepth stops
    # there, as the kernels' schedule does (min(max_sched, D))
    max_depth_sched = min(int(max_depth_c.max()), config.max_treedepth)
    store_v = _diag_inverse_mass(potential) is None

    v_start = velocity_b(start.p) if store_v else None
    zero_node = _leaf_node(start, torch.zeros(C, dtype=dtype, device=dev), v=v_start)
    stack = TreeNode(*(None if x is None else
                       torch.zeros((config.max_treedepth,) + tuple(x.shape), dtype=x.dtype,
                                   device=dev) for x in zero_node))
    left = right = start
    left_v = right_v = v_start
    p_sum = start.p
    prop_q, prop_energy, prop_logp = start.q, start.energy, start.logp
    log_size = torch.zeros(C, dtype=dtype, device=dev)
    lwas = torch.full((C,), float("-inf"), dtype=dtype, device=dev)
    depth = 0
    depth_c = torch.zeros(C, dtype=torch.int32, device=dev)
    n_proposals = torch.zeros(C, dtype=torch.int32, device=dev)
    mec = torch.zeros(C, dtype=dtype, device=dev)
    diverging = torch.zeros(C, dtype=torch.bool, device=dev)
    turning = torch.zeros_like(diverging)

    while depth < max_depth_sched:
        active = ~diverging & ~turning & (depth_c < max_depth_c)
        if not _any(rng, active):  # host read: one per doubling
            break
        keys_next, k_dir, k_sub, k_swap = rng.split(keys, 4)
        keys = rng.where(active, keys_next, keys)

        go_right = rng.bernoulli(k_dir)
        eps_signed = torch.where(go_right, step_size, -step_size)
        edge = _mwhere(go_right, right, left)

        sub = _build_subtree(rng, k_sub, edge, depth, eps_signed, active, start.energy, mec,
                             stack, velocity_b, kinetic_b, logp_grad_b, config,
                             store_velocity=store_v)
        ok = active & ~sub.diverging & ~sub.turning
        node = sub.node

        # multinomial swap against the old tree's weight (reference nuts.py:321-323)
        take_new = ok & _logbern_b(rng, k_swap, node.log_size - log_size)
        old_p_sum, old_left, old_right = p_sum, left, right
        old_left_v, old_right_v = left_v, right_v
        prop_q = torch.where(take_new[:, None], node.q, prop_q)
        prop_energy = torch.where(take_new, node.energy, prop_energy)
        prop_logp = torch.where(take_new, node.logp, prop_logp)
        log_size = torch.where(ok, torch.logaddexp(log_size, node.log_size), log_size)
        lwas = torch.where(ok, torch.logaddexp(lwas, node.log_weighted_accept_sum), lwas)
        p_sum = torch.where(ok[:, None], old_p_sum + node.p_sum, old_p_sum)

        # the new span's ends in position order: the subtree's far end (its
        # last integrated state) replaces the extended edge
        left = _mwhere(ok & ~go_right, sub.end_state, old_left)
        right = _mwhere(ok & go_right, sub.end_state, old_right)
        go = go_right[:, None]
        if store_v:
            v_end = velocity_b(sub.end_state.p)  # once a doubling
            okm = ok[:, None]
            left_v = torch.where(okm & ~go, v_end, old_left_v)
            right_v = torch.where(okm & go, v_end, old_right_v)
            v_left, v_right = left_v, right_v
            v1a = torch.where(go, old_left_v, node.right_v)
            v1b = torch.where(go, node.left_v, old_left_v)
            v2a = torch.where(go, old_right_v, node.left_v)
            v2b = torch.where(go, node.right_v, old_right_v)
        else:
            v_left, v_right = velocity_b(left.p), velocity_b(right.p)
            v1a = velocity_b(torch.where(go, old_left.p, node.right_p))
            v1b = velocity_b(torch.where(go, node.left_p, old_left.p))
            v2a = velocity_b(torch.where(go, old_right.p, node.left_p))
            v2b = velocity_b(torch.where(go, node.right_p, old_right.p))

        # the 3-way generalized U-turn on the merged span (reference nuts.py:332-340)
        turning_full = (_rowdot(p_sum, v_left) <= 0) | (_rowdot(p_sum, v_right) <= 0)
        p_sum1 = torch.where(go, old_p_sum + node.left_p, node.p_sum + old_left.p)
        turning1 = (_rowdot(p_sum1, v1a) <= 0) | (_rowdot(p_sum1, v1b) <= 0)
        p_sum2 = torch.where(go, old_right.p + node.p_sum, node.left_p + old_p_sum)
        turning2 = (_rowdot(p_sum2, v2a) <= 0) | (_rowdot(p_sum2, v2b) <= 0)
        turning_new = turning_full | turning1 | turning2

        depth += 1
        depth_c = depth_c + active.to(torch.int32)
        n_proposals = n_proposals + torch.where(active, sub.n_leaves, 0)
        mec = torch.where(active, sub.max_energy_change, mec)
        diverging = diverging | (active & sub.diverging)
        turning = turning | (active & torch.where(ok, turning_new, sub.turning))

    # mean_tree_accept with the initial state's unit weight removed
    # (reference nuts.py:419-425)
    mta = torch.where(log_size > 0, torch.exp(lwas - (log_size + log1mexp(log_size))),
                      torch.zeros_like(log_size))
    return TreeResult(prop_q=prop_q, prop_energy=prop_energy, prop_logp=prop_logp,
                      depth=depth_c, n_proposals=n_proposals, mean_tree_accept=mta,
                      max_energy_change=mec, diverging=diverging, turning=turning,
                      reached_max_treedepth=~diverging & ~turning)

def _shared_dense_cov(potential, pooled: bool = False) -> Optional[torch.Tensor]:
    """The ``(n, n)`` covariance every chain shares, or None.

    ``QuadPotentialFull`` always qualifies (row 0 of a broadcast).
    ``QuadPotentialFullAdapt`` qualifies only under cross-chain pooled
    adaptation: ``sample()`` overwrites every chain's metric with the pooled
    estimate each tuning step, so row 0 is the shared matrix at every
    kernel entry.
    """
    if isinstance(potential, QuadPotentialFull) or (
            pooled and isinstance(potential, QuadPotentialFullAdapt)):
        return potential.cov[0].contiguous()
    return None


def _shared_lowrank_factor(potential, pooled: bool = False):
    """The factor block of a pooled low-rank metric, or None (reference
    ``nuts.py:662-680``): row 0's ``(V, lam, alpha)``, which the pool keeps
    the same for every chain. Per-chain low-rank adaptation keeps a basis
    per chain, which no kernel models: it runs on the tree."""
    if pooled and isinstance(potential, QuadPotentialLowRankAdapt):
        return build_lowrank_fac(potential.vecs[0], potential.lam[0], potential.alpha[0])
    return None


def trajectory_metric(potential, pooled: bool):
    """``(metric, var, fac)`` of the trajectory kernel for a chain-batched
    metric (``fac`` the low-rank metric's factor block, ``var`` then the
    chains' scales), or None where the kernel does not take it (per-chain
    dense and low-rank adaptation, ``QuadPotentialFullInv``): such a
    metric runs on the tree."""
    if isinstance(potential, (QuadPotentialDiag, QuadPotentialDiagAdapt)):
        # a pooled diagonal is one row expanded over the chains
        return "diag", potential.inverse_mass.contiguous(), None
    cov = _shared_dense_cov(potential, pooled)
    if cov is not None:
        return "dense", cov, None
    fac = _shared_lowrank_factor(potential, pooled)
    return None if fac is None else ("lowrank", potential.stds.contiguous(), fac)


def shard_blocks(shard, chains: int, chain_block: int) -> Tuple[int, Optional[int]]:
    """``(block0, blocks)`` of a launch on this rank's ``chains`` chains in
    blocks of ``chain_block`` (:func:`resolve_chain_block`): the global
    index of its first block and the blocks of every rank; ``(0, None)``
    without a mesh of more than one rank."""
    if shard is None or shard.size == 1:
        return 0, None
    cb = resolve_chain_block(chains, chain_block)
    return shard.lo // cb, shard.chains // cb


def build_nuts_kernel(config: NUTSConfig = NUTSConfig(),
                      trajectory_spec: Optional[TrajectorySpec] = None,
                      pooled_metric: bool = False,
                      batched_logp_grad_fn: Optional[BatchedLogpGrad] = None,
                      shard=None) -> Callable[..., Tuple[ChainState, NUTSInfo]]:
    """``kernel(state, tuning, generator, seed) -> (state, info)``.

    ``generator`` draws the momenta (on the state's device) and, on the
    tree, the tree's random numbers: a ``torch.Generator``, or a seed
    list's :class:`~littlemcmc_torch.streams.DrawStream`; ``seed`` is the
    trajectory kernel's two int32 counter-stream words for this draw.
    ``config.step_rand`` (``step_rand(step_size (C,), generator) ->
    (C,)``, the ``torch.Generator``) redraws the step sizes before the
    trajectory (reference ``nuts.py:737-738``). With a
    ``trajectory_spec`` each draw is one trajectory-kernel launch for all
    chains (``pooled_metric``: the state's adaptive dense metric is pooled
    across chains, so its row 0 is the covariance the kernel shares);
    without one (or for a pooled low-rank metric, the pair of the chains'
    scales and the shared factor block), :func:`run_nuts_tree` calls
    ``batched_logp_grad_fn``
    (``(C, n) -> ((C,), (C, n))``) at every leaf and once more at the
    proposal (reference ``nuts.py:863-873``). ``shard``: the rank's
    :class:`~littlemcmc_torch.parallel.mesh.ChainShard` under a mesh, whose
    chains the kernel launches on as the global blocks they are
    (:func:`shard_blocks`).
    """
    if trajectory_spec is None and batched_logp_grad_fn is None:
        raise ValueError("the tensor-op tree needs batched_logp_grad_fn")
    chain_block = config.chain_block or DEFAULT_CHAIN_BLOCK

    def kernel(state: ChainState, tuning: bool, generator: torch.Generator,
               seed: Sequence[int]) -> Tuple[ChainState, NUTSInfo]:
        pot = state.potential
        p0 = pot.sample_momentum(generator)
        start_energy = pot.kinetic(p0) - state.logp

        adapting = tuning and config.adapt_step_size
        step_size = state.da.current(adapting)
        if config.step_rand is not None:
            step_size = config.step_rand(step_size, torch_generator(generator))

        # early tree-depth schedule (reference nuts.py:205-208)
        early = tuning & (state.iter_count < config.early_window)
        max_depth_c = torch.where(
            early, torch.full_like(state.iter_count, config.early_max_treedepth),
            torch.full_like(state.iter_count, config.max_treedepth))

        if trajectory_spec is None:
            start = PhaseState(state.q, p0, state.q_grad, start_energy, state.logp)
            rng, keys = tree_random(generator, state.q.shape[0], state.q.device)
            tree = run_nuts_tree(rng, keys, start, step_size, max_depth_c, pot,
                                 batched_logp_grad_fn, config)
            # the proposal's gradient is not carried through the tree:
            # recomputed once at the accepted position (reference nuts.py:869-873)
            prop_logp, prop_grad = batched_logp_grad_fn(tree.prop_q)
            out = dict(q=tree.prop_q, grad=prop_grad, logp=prop_logp,
                       energy=tree.prop_energy, depth=tree.depth,
                       n_leaves=tree.n_proposals, diverging=tree.diverging,
                       turning=tree.turning, max_energy_change=tree.max_energy_change)
            mta, model_logp = tree.mean_tree_accept, tree.prop_logp
        else:
            metric_var = trajectory_metric(pot, pooled_metric)
            if metric_var is None:
                raise ValueError(
                    "the trajectory kernel takes a diagonal metric, a static dense one or "
                    "a cross-chain pooled adaptive dense or low-rank one; other metrics run "
                    "on the tensor-op tree (trajectory_spec=None)")
            metric, var, fac = metric_var
            out = trajectory(state.q, p0, state.q_grad, state.logp, step_size,
                             max_depth_c, var, seed,
                             spec=trajectory_spec, max_treedepth=config.max_treedepth,
                             Emax=config.Emax, chain_block=chain_block,
                             integrator=config.integrator, metric=metric, fac=fac,
                             block0=shard_blocks(shard, state.q.shape[0], chain_block)[0])
            log_size = out["log_size"]
            mta = torch.where(
                log_size > 0,
                torch.exp(out["log_weighted_accept_sum"] - (log_size + log1mexp(log_size))),
                torch.zeros_like(log_size))
            model_logp = out["logp"]

        new_state = finish_step(state, out["q"], out["grad"], out["logp"], mta,
                                tuning, config)
        not_stopped = ~out["diverging"] & ~out["turning"]
        info = NUTSInfo(
            depth=out["depth"],
            step_size=torch.exp(new_state.da.log_step),
            tune=torch.full_like(out["diverging"], tuning),
            mean_tree_accept=mta,
            step_size_bar=torch.exp(new_state.da.log_bar),
            tree_size=out["n_leaves"].to(torch.float32),
            diverging=out["diverging"],
            energy_error=out["energy"] - start_energy,
            energy=out["energy"],
            max_energy_error=out["max_energy_change"],
            model_logp=model_logp,
            reached_max_treedepth=not_stopped & (not tuning),
        )
        return new_state, info

    return kernel


# --------------------------------------------------------------------------
# The fused engine
# --------------------------------------------------------------------------

def _pool_dense_welford(pot: QuadPotentialFullAdapt):
    """Global pooled moments of a chain-batched ``QuadPotentialFullAdapt``:
    the exact Chan combination over chains of both windows, as full
    ``(mean, raw, weight)`` states, plus the shared counters as 0-d float32
    tensors (reference ``nuts.py:927-950``)."""
    f32 = torch.float32

    def pool(wf):
        nc = wf.n_samples.to(f32)  # (C,)
        N = torch.sum(nc)
        M = torch.sum(nc[:, None] * wf.mean, dim=0) / torch.clamp(N, min=1e-30)
        d = wf.mean - M
        raw = torch.sum(wf.raw_cov, dim=0) + torch.einsum("c,ci,cj->ij", nc, d, d)
        return M, raw, N

    fgM, fgR, fgW = pool(pot.fg)
    bgM, bgR, bgW = pool(pot.bg)
    return (fgM, fgR, fgW, bgM, bgR, bgW, pot.n_samples[0].to(f32),
            pot.prev_update[0].to(f32), pot.window[0].to(f32))


def _dense_boundary_potential(pot: QuadPotentialFullAdapt, outs, c_fg: torch.Tensor,
                              C: int, share: Optional[int] = None) -> QuadPotentialFullAdapt:
    """The pooled dense metric at a chunk boundary from the fused op's
    per-block Welford states (reference ``nuts.py:967-1003``).

    Chan-combines the blocks, refreshes the shared metric with the pooled
    covariance ``raw / (W - 1)`` and its Cholesky factor (keeping the
    previous factor and latching ``chol_failed`` where it fails), and
    stores the pooled state in replicated per-chain form: each chain
    carries 1/C of the weight at the pooled mean, so Chan-combining the C
    rows gives back the global state and the per-draw engine can take
    over. Rows are views of one matrix; the pooled metric's rows are
    identical before and after. Under a mesh ``C`` is this rank's chains
    and ``share`` every rank's, over which the weight is shared (default
    ``C``).
    """
    Wf, Mf, Rf = combine_dense_welford(outs["dense_fg_w"], outs["dense_fg_mean"],
                                       outs["dense_fg_raw"], c_fg)
    Wb, Mb, Rb = combine_dense_welford(outs["dense_bg_w"], outs["dense_bg_mean"],
                                       outs["dense_bg_raw"], c_fg)
    cov_new = Rf / torch.clamp(Wf - 1.0, min=1.0)
    chol, ok = cholesky_or_keep(cov_new, pot.chol[0])
    n = cov_new.shape[0]
    cov = torch.where(ok, cov_new, pot.cov[0])
    Cf = float(share or C)

    def rep(x):
        return x.expand(C, *x.shape)

    def counter(k):
        return outs[k].to(torch.int32).expand(C)

    return dataclasses.replace(
        pot, cov=rep(cov), chol=rep(chol), chol_failed=pot.chol_failed | ~ok,
        fg=WelfordCovariance(n_samples=rep(Wf / Cf), mean=rep(Mf), raw_cov=rep(Rf / Cf)),
        bg=WelfordCovariance(n_samples=rep(Wb / Cf), mean=rep(Mb), raw_cov=rep(Rb / Cf)),
        n_samples=counter("n_samples"), prev_update=counter("prev_update"),
        window=counter("window"))


def fused_metric_kind(potential_template, pooled: bool) -> str:
    """Which fused branch runs a metric: ``diag_static``
    (``QuadPotentialDiag``), ``diag_adapt`` (``QuadPotentialDiagAdapt``,
    per chain or, with ``pooled``, pooled at chunk boundaries),
    ``dense_static`` (``QuadPotentialFull``), ``dense_pooled`` (``pooled``
    and ``QuadPotentialFullAdapt``) or ``lowrank_pooled`` (``pooled`` and
    ``QuadPotentialLowRankAdapt``); raises for any other (reference
    ``nuts.py:1059-1072``)."""
    if isinstance(potential_template, QuadPotentialDiagAdapt):
        return "diag_adapt"
    if isinstance(potential_template, QuadPotentialDiag):
        return "diag_static"
    if isinstance(potential_template, QuadPotentialFull):
        return "dense_static"
    if pooled and isinstance(potential_template, QuadPotentialFullAdapt):
        return "dense_pooled"
    if pooled and isinstance(potential_template, QuadPotentialLowRankAdapt):
        return "lowrank_pooled"
    raise NotImplementedError(
        "the fused kernels of littlemcmc_torch run a diagonal metric, a static dense "
        "metric or a cross-chain pooled adaptive dense or low-rank metric; per-chain dense "
        "and low-rank adaptation and QuadPotentialFullInv run on the per-draw engine (the "
        "tensor-op tree for NUTS)")


def fused_metric_inputs(kind: str, pot, tuning: bool, group=None) -> dict:
    """The metric arguments of a fused launch from the chunk's starting
    metric (reference ``nuts.py:1106-1139``): ``metric``, ``var``, ``linv``,
    ``welford``, ``dense_welford`` and ``fac``. The shared covariance and
    ``L^{-1}`` (one triangular solve a chunk) with, in pooled tune chunks,
    the global pooled Welford state; or the per-chain variances with, in
    tune chunks of an adaptive diag or low-rank metric, the per-chain
    Welford state (``_fused_welford_tuple`` ``:920``), and for the low-rank
    metric the factor block of row 0, frozen for the chunk. Draw chunks
    leave the variances as they are, so they pass no Welford state.
    ``group``: the pooled state is pooled over every rank's chains."""
    args = dict(linv=None, welford=None, dense_welford=None, fac=None)
    if kind.startswith("dense"):
        cov = pot.cov[0].contiguous()
        eye = torch.eye(cov.shape[0], dtype=cov.dtype, device=cov.device)
        pooled_tune = tuning and kind == "dense_pooled"
        return dict(args, metric="dense", var=cov,
                    linv=torch.linalg.solve_triangular(pot.chol[0], eye, upper=False),
                    dense_welford=(_pool_dense_welford(pot.replace(
                        fg=gather_tree(pot.fg, group), bg=gather_tree(pot.bg, group)))
                        if pooled_tune else None))
    if kind == "diag_static":
        return dict(args, metric="diag", var=pot.v)
    args.update(var=pot.var.contiguous(), welford=pot.welford_leaves() if tuning else None)
    if kind == "lowrank_pooled":
        return dict(args, metric="lowrank", fac=_shared_lowrank_factor(pot, True))
    return dict(args, metric="diag")


_DENSE_BLOCK_KEYS = ("dense_fg_w", "dense_fg_mean", "dense_fg_raw", "dense_bg_w",
                     "dense_bg_mean", "dense_bg_raw")


def fused_metric_after(pot, outs, tuning: bool, pooled: bool, dense_welford, C: int,
                       group=None):
    """The metric at the chunk boundary from the fused op's outputs: an
    adaptive diag metric rebuilt from the updated per-chain state and, in
    pooled tune chunks, pooled across chains once (reference
    ``nuts.py:1223-1274``); the low-rank metric with its updated variances,
    ``buf_fill`` set to 0 (the kernel keeps no ring buffer, so a per-draw
    update must refill it first) and, after a tune chunk,
    :func:`~littlemcmc_torch.parallel.cross_chain.lowrank_boundary_refresh`
    on the chunk's last positions; the pooled dense metric refreshed from
    the combined block states (:func:`_dense_boundary_potential`); a static
    metric as it was. ``group``: pool over every rank's chains, the dense
    metric from every rank's blocks, gathered in global block order."""
    if "var" in outs:
        pot = pot.with_welford_leaves(outs["var"], [outs[k] for k in WELFORD_KEYS])
    if isinstance(pot, QuadPotentialLowRankAdapt):
        pot = pot.replace(buf_fill=torch.zeros_like(pot.buf_fill))
        return lowrank_boundary_refresh(pot, outs["q"], group) if tuning else pot
    if "var" in outs:
        return cross_chain_potential_pool(pot, pooled and tuning, group=group)
    if dense_welford is None:
        return pot
    size = group_rank_size(group)[1]
    if size > 1:
        outs = {**outs, **{k: gather_chains(outs[k], group) for k in _DENSE_BLOCK_KEYS}}
    return _dense_boundary_potential(pot, outs, dense_welford[0], C, C * size)


def build_fused_nuts_runner_factory(config: NUTSConfig, trajectory_spec: TrajectorySpec,
                                    potential_template, pooled: bool,
                                    seed_words: Tuple[int, int], shard=None):
    """Chunk-runner factory of the fused multi-draw NUTS kernel.

    Returns ``factory(chunk, tuning, collect) -> run_chunk`` with
    ``run_chunk(state, iter0) -> (state, (trace, NUTSInfo) | None, ndiv)``:
    one fused-op launch runs the ``chunk`` transitions that start at global
    iteration ``iter0``. ``trace`` is ``(chunk, C, n)``, every stat of
    ``NUTSInfo`` ``(chunk, C)`` and ``ndiv`` the divergences, a tensor on
    the state's device.

    ``potential_template`` gives the metric's structure
    (:func:`fused_metric_kind`):

    - diagonal (``QuadPotentialDiag``, ``QuadPotentialDiagAdapt``): every
      chunk fused; an adaptive metric runs each chain's Welford updates in
      the kernel through its tune chunks and, with ``pooled``, is pooled
      across chains once at each tune chunk's boundary (mid-chunk each
      chain rides its own estimate, reference ``nuts.py:1073-1088``). Tune
      chunks of ``_AUTO_CHUNK`` draws;
    - static dense (``QuadPotentialFull``): every chunk with the frozen
      metric; momentum ``z @ L^{-1}``, velocities ``p @ cov``;
    - pooled dense (``pooled`` and ``QuadPotentialFullAdapt``): tune chunks
      carry the block-local pooled Welford state on chip and the epilogue
      refreshes the metric at the chunk boundary
      (:func:`_dense_boundary_potential`); draw chunks run with the frozen
      post-tune metric. Tune chunks follow :func:`pooled_tune_schedule`;
    - pooled low-rank (``pooled`` and ``QuadPotentialLowRankAdapt``): each
      chain's variances adapt in the kernel through the tune chunks, the
      factor freezes for each chunk and refreshes at tune chunks'
      boundaries (:func:`fused_metric_after`); tune chunks follow
      :func:`pooled_tune_schedule`.

    ``seed_words``: the run's two seed words ``(w0, w1)``. Chunk seeds fold
    the global iteration in (``w0 + iter0 * 15485863``), so the draws do not
    depend on the chunking (reference ``nuts.py:1190-1207``).

    ``shard``: the rank's :class:`~littlemcmc_torch.parallel.mesh.ChainShard`
    under a mesh. Its blocks launch as the global blocks they are, seeded
    with their share of the pooled dense state (:func:`shard_blocks`), and
    each boundary pools over every rank (:func:`fused_metric_after`).
    """
    kind = fused_metric_kind(potential_template, pooled)
    group = None if shard is None else shard.group
    if trajectory_spec is None:
        raise NotImplementedError(_NO_SPEC)
    mult = (1.0 if kind.endswith("static") else potential_template.window_multiplier)
    w0, w1 = seed_words
    chain_block = config.chain_block or DEFAULT_CHAIN_BLOCK

    def factory(chunk: int, tuning: bool, collect: bool):
        def run_chunk(state: ChainState, iter0: int):
            pot = state.potential
            C = state.q.shape[0]
            block0, blocks = shard_blocks(shard, C, chain_block)
            m = fused_metric_inputs(kind, pot, tuning, group)
            da = state.da
            outs = fused_nuts(
                state.q, state.q_grad, state.logp, state.iter_count.to(torch.float32),
                da.log_step, da.log_bar, da.hbar, da.count.to(torch.float32), da.mu,
                m["var"], m["linv"], ((w0 + iter0 * 15485863) & 0xFFFFFFFF, w1),
                spec=trajectory_spec, T=chunk, tuning=bool(tuning), config=config,
                metric=m["metric"], window_multiplier=mult, chain_block=chain_block,
                collect_trace=collect, welford=m["welford"],
                dense_welford=m["dense_welford"], fac=m["fac"], block0=block0,
                welford_blocks=blocks)
            new_state = ChainState(
                q=outs["q"], q_grad=outs["grad"], logp=outs["logp"],
                potential=fused_metric_after(pot, outs, tuning, pooled, m["dense_welford"],
                                             C, group),
                da=DualAverageState(log_step=outs["da_log_step"],
                                    log_bar=outs["da_log_bar"], hbar=outs["da_hbar"],
                                    count=outs["da_count"].to(torch.int32),
                                    mu=outs["da_mu"]),
                iter_count=outs["iter_count"].to(torch.int32))
            ndiv = outs["diverging"].sum(dtype=torch.int32)
            if not collect:
                return new_state, None, ndiv
            info = NUTSInfo(
                depth=outs["depth"], step_size=outs["step_size"],
                tune=torch.full_like(outs["diverging"], bool(tuning)),
                mean_tree_accept=outs["mean_tree_accept"],
                step_size_bar=outs["step_size_bar"],
                tree_size=outs["n_leaves"].to(torch.float32),
                diverging=outs["diverging"], energy_error=outs["energy_error"],
                energy=outs["energy"], max_energy_error=outs["max_energy_change"],
                model_logp=outs["model_logp"],
                reached_max_treedepth=(~outs["diverging"] & ~outs["turning"]
                                       & (not tuning)))
            return new_state, (outs["trace"], info), ndiv

        return run_chunk

    if kind in ("dense_pooled", "lowrank_pooled"):
        # the shared metric refreshes only at chunk boundaries, so the tune
        # chunks are the adaptation schedule (reference nuts.py:1309-1326;
        # the reference's tune_chunk_cap of 50 is never read beside a
        # schedule)
        factory.tune_chunk_schedule = pooled_tune_schedule
    return factory
