"""One whole NUTS transition per chain: the trajectory op.

Counterpart of ``littlemcmc_tpu/ops/nuts_trajectory_pallas.py::
build_trajectory_op`` with ``metric="diag"`` or ``metric="dense"`` and
``pack=1``. One call builds each chain's whole tree: the merge stack, the
edge states and the proposal stay inside the op, and the model's
``(logp, grad)`` is inlined. The diag metric is a per-chain inverse-mass
diagonal (velocity ``var * p``); the dense metric is one ``(n, n)``
covariance shared by every chain (velocity ``p @ var``,
``make_velocities(V, "dense")``, ``nuts_trajectory_pallas.py:309-333``).
It does the multinomial swaps, the 3-way generalized U-turn, divergence
on ``|dE| >= Emax`` with NaN counted as infinite, and each chain's own
depth cap.

Two implementations compute the same function:

- :func:`trajectory_plain`, plain PyTorch, which runs for tensors on the
  CPU and is the yardstick the CUDA kernel is held against;
- the CUDA kernel ``csrc/nuts_trajectory.cu``, which runs for tensors on
  a CUDA device.

:func:`trajectory` picks by the tensors' device and never falls back.

Randomness is the JAX kernel's counter stream (``_fmix32`` and
``_make_counter_uniform``, ``nuts_trajectory_pallas.py:152-165``,
``:336-371``): a murmur3 hash of a per-chain salt and a call counter
shared by the chains of one block. The counter moves with the block's
control flow, so both implementations run each chain block in lockstep:
the depth, leaf and merge loops continue while *any* chain of the block
needs them. Given the same ``chain_block``, the JAX kernel under
``interpret=True``, this plain version and the CUDA kernel draw the same
numbers and build the same trees.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, Tuple

import torch

from ..integration import INTEGRATOR_COEFFS
from ..math import fp32_matmul

__all__ = ["TrajectorySpec", "fmix32", "counter_salt", "counter_uniform",
           "resolve_chain_block", "trajectory", "trajectory_plain",
           "body_logp_grad", "DEFAULT_CHAIN_BLOCK", "METRIC_IDS"]

# Chains per CUDA thread block, one warp per chain: 128 blocks at the
# main path's 1024 chains for the card's 132 SMs.
DEFAULT_CHAIN_BLOCK = 8
# 16 warps of 32 threads at up to 128 registers fill an SM's 65,536
MAX_KERNEL_CHAIN_BLOCK = 16
MAX_KERNEL_NDIM_DENSE = 256  # register tile of the dense model body

# model bodies and metrics compiled into the kernels (ids match
# csrc/nuts_transition.cuh)
BODY_IDS = {"standard_normal": 0, "correlated_gaussian": 1, "eight_schools": 2}
METRIC_IDS = {"diag": 0, "dense": 1}

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_CALLS_PER_HASH = 64  # the plain version hashes its stream in batches


@dataclasses.dataclass(frozen=True, eq=False)
class TrajectorySpec:
    """A model the trajectory op inlines: a body the kernel knows by name
    plus its constants (tensors on the model's device).

    ``standard_normal``: no constants; ``logp = -q.q/2``, ``grad = -q``.
    ``correlated_gaussian``: the ``(n, n)`` fp32 precision ``P``;
    ``grad = -q P``, ``logp = q.grad/2``.
    ``eight_schools``: the non-centred eight schools at ``n = 10``
    (``q = [mu, log_tau, theta_tilde_1..8]``); one ``(2, 10)`` fp32
    constant, ``y`` and ``1/sigma^2`` in columns 2..9 and zero in
    columns 0 and 1 (``models/eight_schools.py:80-101``).

    ``packable``: the JAX model's spec has a lane-packed body
    (``packed_fn``). Nothing in the port packs lanes; the flag only
    takes part in the engine election, as ``resolve_pack`` does there.
    """

    body: str
    consts: Tuple[torch.Tensor, ...]
    ndim: int
    packable: bool = False

    def __post_init__(self):
        if self.body not in BODY_IDS:
            raise ValueError(f"unknown model body {self.body!r}; "
                             f"known: {sorted(BODY_IDS)}")
        if self.body == "eight_schools" and self.ndim != 10:
            raise ValueError(f"the eight_schools body has 10 parameters, not {self.ndim}")
        want = {"standard_normal": [], "correlated_gaussian": [(self.ndim, self.ndim)],
                "eight_schools": [(2, 10)]}[self.body]
        if [tuple(c.shape) for c in self.consts] != want:
            raise ValueError(f"the {self.body} body takes constants of shapes {want}, got "
                             f"{[tuple(c.shape) for c in self.consts]}")


def body_logp_grad(spec: TrajectorySpec, q: torch.Tensor):
    """The body's plain ``(logp (C,), grad (C, n))`` at ``q (C, n)``."""
    if spec.body == "standard_normal":
        return -0.5 * (q * q).sum(1), -q
    if spec.body == "eight_schools":
        return _eight_schools_logp_grad(spec.consts[0], q)
    (prec,) = spec.consts
    g = -fp32_matmul(q, prec)
    return 0.5 * (q * g).sum(1), g


def _eight_schools_logp_grad(consts: torch.Tensor, q: torch.Tensor):
    """The eight-schools body in the arithmetic of the JAX spec's ``fn``
    (``models/eight_schools.py:80-101``): ``theta_tilde`` masked to columns
    2..9, ``y`` and ``1/sigma^2`` zero outside them."""
    y, is2 = consts[0], consts[1]
    mu, log_tau = q[:, 0:1], q[:, 1:2]
    tau = torch.exp(log_tau)
    tt = torch.cat([torch.zeros_like(q[:, :2]), q[:, 2:]], 1)
    theta = mu + tau * tt
    dy = y - theta
    resid = dy * is2  # zero outside the theta columns
    lp = (-0.5 * (mu / 5.0) ** 2 - 0.5 * (log_tau / 5.0) ** 2
          - 0.5 * (tt * tt).sum(1, keepdim=True) - 0.5 * (dy * resid).sum(1, keepdim=True))
    dmu = -mu / 25.0 + resid.sum(1, keepdim=True)
    dlog_tau = -log_tau / 25.0 + tau * (resid * tt).sum(1, keepdim=True)
    dtt = -tt + tau * resid
    return lp[:, 0], torch.cat([dmu, dlog_tau, dtt[:, 2:]], 1)


# --------------------------------------------------------------------------
# The counter PRNG, in int64 arithmetic (CPU torch lacks uint32 products)
# --------------------------------------------------------------------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for ``x`` holding uint32 values in int64, with
    no intermediate above 2^48 (so no signed overflow)."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """The murmur3 32-bit finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def counter_salt(seed0: int, seed1: int, block_id: int, rows: int,
                 device=None) -> torch.Tensor:
    """Per-chain salts of one chain block (int64 holding uint32).

    ``base = seed0 + block_id*7919`` and ``base + row*101027`` wrap as
    int32 in the JAX kernel; reading the wrapped int32 as uint32 is the
    sum mod 2^32, which is what Python integers give here.
    """
    row = torch.arange(rows, dtype=torch.int64, device=device)
    mixed = (seed0 + block_id * 7919 + row * 101027) & _M32
    s1 = ((seed1 & _M32) * _GOLDEN) & _M32
    return fmix32(mixed ^ s1)


def counter_uniform(salt: torch.Tensor, call) -> torch.Tensor:
    """U(0, 1) of call number ``call`` (1-based; an int, or an int64 tensor
    that broadcasts against ``salt``) for each salt, as float32."""
    x = fmix32(salt ^ ((call * _GOLDEN) & _M32))
    return ((x >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def resolve_chain_block(chains: int, chain_block: int) -> int:
    """The JAX op's rule: start at ``min(chain_block, chains)``, halve
    until it divides ``chains``."""
    cb = min(chain_block, chains)
    while chains % cb:
        cb //= 2
    return cb


# --------------------------------------------------------------------------
# The plain version
# --------------------------------------------------------------------------

def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.logaddexp``'s formula, so both packages round alike."""
    d = a - b
    out = torch.maximum(a, b) + torch.log1p(torch.exp(-torch.abs(d)))
    return torch.where(torch.isnan(d), a + b, out)


def _rowdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(1)


def _col(x: torch.Tensor) -> torch.Tensor:
    return x[:, None]


def metric_velocity(var: torch.Tensor, metric: str) -> Callable:
    """The velocity ``p -> M^{-1} p`` of a metric: ``var * p`` for a
    per-chain diagonal, ``p @ var`` for a shared dense covariance."""
    if metric == "diag":
        return lambda p: var * p
    if metric == "dense":
        return lambda p: fp32_matmul(p, var)
    raise ValueError(f"unknown metric {metric!r}; known: {sorted(METRIC_IDS)}")


def transition_block(model: Callable, vel: Callable, uniform: Callable, coeffs,
                     Emax: float, D: int, q0, p0, g0, lp0, E0, eps,
                     mdc) -> Dict[str, torch.Tensor]:
    """One chain block's transition from start energy ``E0``:
    ``_run_transition`` (``nuts_trajectory_pallas.py:374-697``) with the
    velocity ``vel``. Block-wide loop conditions are ``any`` over the
    block's chains, as in the kernels. The fused op's plain version runs
    it too."""
    CB, n = q0.shape
    dev = q0.device
    f32 = torch.float32
    b_coef, a_coef = coeffs

    def logbern(log_p):
        return torch.log(uniform()) < log_p

    def any_(m):
        return bool(m.any())

    l_q, l_p, l_g = q0, p0, g0
    r_q, r_p, r_g = q0, p0, g0
    pr_q, psum = q0, p0
    pr_e, pr_lp = E0, lp0
    c_e, c_lp = E0, lp0

    # merge stack: subtree (left p, right p, p sum, proposal q) plus the
    # proposal's energy and logp and the subtree's log size and log
    # weighted accept sum
    s_lp = torch.zeros((D, CB, n), dtype=f32, device=dev)
    s_rp = torch.zeros_like(s_lp)
    s_ps = torch.zeros_like(s_lp)
    s_q = torch.zeros_like(s_lp)
    s_e = torch.zeros((D, CB), dtype=f32, device=dev)
    s_lpp = torch.zeros_like(s_e)
    s_ls = torch.zeros_like(s_e)
    s_lw = torch.zeros_like(s_e)

    acc_ls = torch.zeros(CB, dtype=f32, device=dev)
    acc_lw = torch.full((CB,), float("-inf"), dtype=f32, device=dev)
    mec = torch.zeros(CB, dtype=f32, device=dev)
    depth_c = torch.zeros(CB, dtype=torch.int32, device=dev)
    n_leaves = torch.zeros(CB, dtype=torch.int32, device=dev)
    div = torch.zeros(CB, dtype=torch.bool, device=dev)
    trn = torch.zeros(CB, dtype=torch.bool, device=dev)

    max_sched = min(int(mdc.max()), D)  # the stack holds D slots
    depth = 0
    cont = max_sched > 0
    while cont:
        active = ~div & ~trn & (depth_c < mdc)
        go_right = uniform() < 0.5
        gr = _col(go_right)
        epss = _col(torch.where(go_right, eps, -eps))
        c_q = torch.where(gr, r_q, l_q)
        c_p = torch.where(gr, r_p, l_p)
        c_g = torch.where(gr, r_g, l_g)
        bld = active.clone()
        sdv = torch.zeros_like(bld)
        stn = torch.zeros_like(bld)
        n_total = 1 << depth

        leaf, h = 0, 0
        go_l = any_(bld)
        while leaf < n_total and go_l:
            # one symplectic step (aborted chains integrate garbage; every
            # consumer of their values is masked)
            pn = c_p + (b_coef[0] * epss) * c_g
            qn, lpn, gn = c_q, c_lp, c_g
            for i, ai in enumerate(a_coef):
                qn = qn + (ai * epss) * vel(pn)
                lpn, gn = model(qn)
                pn = pn + (b_coef[i + 1] * epss) * gn
            en = 0.5 * _rowdot(pn, vel(pn)) - lpn
            c_q, c_p, c_g, c_e, c_lp = qn, pn, gn, en, lpn

            dE = en - E0
            dE = torch.where(torch.isnan(dE), torch.full_like(dE, float("inf")), dE)
            upd = bld & (dE.abs() > mec.abs())
            mec = torch.where(upd, dE, mec)
            div_leaf = bld & ~(dE.abs() < Emax)
            n_leaves = n_leaves + bld.to(torch.int32)
            lpaw = -dE + torch.clamp(-dE, max=0.0)

            mrg = bld & ~div_leaf
            is_odd = leaf & 1
            go_m0 = any_(mrg)
            if not is_odd:
                # even leaf: a leaf slot has left p == right p == p sum
                s_ps[h], s_q[h] = c_p, c_q
                s_e[h], s_lpp[h], s_ls[h], s_lw[h] = c_e, c_lp, -dE, lpaw
            elif go_m0:
                # leaf (+) leaf, peeled (nuts_trajectory_pallas.py:505-538)
                t1_p = s_ps[h - 1]
                t2_p = c_p
                ps = t1_p + t2_p
                turn = (_rowdot(ps, vel(t1_p)) <= 0) | (_rowdot(ps, vel(t2_p)) <= 0)
                t2_ls = -dE
                ls = _logaddexp(s_ls[h - 1], t2_ls)
                lw = _logaddexp(s_lw[h - 1], lpaw)
                take2 = logbern(t2_ls - ls)
                s_q[h - 1] = torch.where(_col(take2), c_q, s_q[h - 1])
                s_e[h - 1] = torch.where(take2, c_e, s_e[h - 1])
                s_lpp[h - 1] = torch.where(take2, c_lp, s_lpp[h - 1])
                s_lp[h - 1], s_rp[h - 1], s_ps[h - 1] = t1_p, t2_p, ps
                s_ls[h - 1], s_lw[h - 1] = ls, lw
                mrg = mrg & ~turn

            # one in-place merge per trailing one-bit of leaf past bit 0
            j, hh = 1, h - is_odd
            go_m = bool(is_odd) and any_(mrg)
            while (leaf >> j) & 1 and go_m:
                t1_lp, t1_rp, t1_ps = s_lp[hh - 1], s_rp[hh - 1], s_ps[hh - 1]
                t2_lp, t2_rp, t2_ps = s_lp[hh], s_rp[hh], s_ps[hh]
                vt1lp, vt1rp = vel(t1_lp), vel(t1_rp)
                vt2lp, vt2rp = vel(t2_lp), vel(t2_rp)
                ps = t1_ps + t2_ps
                turn = (_rowdot(ps, vt1lp) <= 0) | (_rowdot(ps, vt2rp) <= 0)
                ps1 = t1_ps + t2_lp
                turn = turn | (_rowdot(ps1, vt1lp) <= 0) | (_rowdot(ps1, vt2lp) <= 0)
                ps2 = t1_rp + t2_ps
                turn = turn | (_rowdot(ps2, vt1rp) <= 0) | (_rowdot(ps2, vt2rp) <= 0)

                ls = _logaddexp(s_ls[hh - 1], s_ls[hh])
                lw = _logaddexp(s_lw[hh - 1], s_lw[hh])
                take2 = logbern(s_ls[hh] - ls)
                s_q[hh - 1] = torch.where(_col(take2), s_q[hh], s_q[hh - 1])
                s_e[hh - 1] = torch.where(take2, s_e[hh], s_e[hh - 1])
                s_lpp[hh - 1] = torch.where(take2, s_lpp[hh], s_lpp[hh - 1])
                s_rp[hh - 1], s_ps[hh - 1] = t2_rp, ps
                s_ls[hh - 1], s_lw[hh - 1] = ls, lw
                mrg = mrg & ~turn
                go_m = any_(mrg)
                j, hh = j + 1, hh - 1

            turned = bld & ~div_leaf & ~mrg
            sdv = sdv | div_leaf
            stn = stn | turned
            bld = bld & ~div_leaf & ~turned
            go_l = any_(bld)
            leaf, h = leaf + 1, hh + 1

        # the finished subtree is slot 0; a depth-0 subtree is one leaf
        n_ps = s_ps[0]
        n_lp = n_ps if depth == 0 else s_lp[0]
        n_rp = n_ps if depth == 0 else s_rp[0]
        ok = active & ~sdv & ~stn

        # multinomial swap against the old tree (reference nuts.py:321-323)
        take_new = ok & logbern(s_ls[0] - acc_ls)
        pr_q = torch.where(_col(take_new), s_q[0], pr_q)
        pr_e = torch.where(take_new, s_e[0], pr_e)
        pr_lp = torch.where(take_new, s_lpp[0], pr_lp)
        acc_ls = torch.where(ok, _logaddexp(acc_ls, s_ls[0]), acc_ls)
        acc_lw = torch.where(ok, _logaddexp(acc_lw, s_lw[0]), acc_lw)
        okc = _col(ok)
        old_ps = psum
        psum = torch.where(okc, old_ps + n_ps, old_ps)
        upd_l = _col(ok & ~go_right)
        upd_r = _col(ok & go_right)
        old_l_p, old_r_p = l_p, r_p
        l_q, l_p, l_g = (torch.where(upd_l, c_q, l_q), torch.where(upd_l, c_p, l_p),
                         torch.where(upd_l, c_g, l_g))
        r_q, r_p, r_g = (torch.where(upd_r, c_q, r_q), torch.where(upd_r, c_p, r_p),
                         torch.where(upd_r, c_g, r_g))

        # 3-way U-turn on the merged span (reference nuts.py:332-340)
        tf = (_rowdot(psum, vel(l_p)) <= 0) | (_rowdot(psum, vel(r_p)) <= 0)
        ps1 = torch.where(gr, old_ps + n_lp, n_ps + old_l_p)
        p1a = torch.where(gr, old_l_p, n_rp)
        p1b = torch.where(gr, n_lp, old_l_p)
        t1c = (_rowdot(ps1, vel(p1a)) <= 0) | (_rowdot(ps1, vel(p1b)) <= 0)
        ps2 = torch.where(gr, old_r_p + n_ps, n_lp + old_ps)
        p2a = torch.where(gr, old_r_p, n_lp)
        p2b = torch.where(gr, n_rp, old_r_p)
        t2c = (_rowdot(ps2, vel(p2a)) <= 0) | (_rowdot(ps2, vel(p2b)) <= 0)
        sel_turn = torch.where(ok, tf | t1c | t2c, stn)

        trn = trn | (active & sel_turn)
        div = div | (active & sdv)
        depth_c = depth_c + active.to(torch.int32)
        nxt = ~div & ~trn & (depth_c < mdc)
        cont = (depth + 1) < max_sched and any_(nxt)
        depth += 1

    # the proposal's gradient is recomputed, not carried (:810-813)
    _, g_f = model(pr_q)
    return dict(q=pr_q, grad=g_f, energy=pr_e, logp=pr_lp, log_size=acc_ls,
                log_weighted_accept_sum=acc_lw, max_energy_change=mec,
                depth=depth_c, n_leaves=n_leaves, diverging=div, turning=trn)


def _seed_words(seed) -> Tuple[int, int]:
    """Two int32 seed words; a single int is used for both (as in JAX)."""
    if isinstance(seed, int):
        return seed, seed
    s0, s1 = (int(x) for x in seed)
    return s0, s1


def int32_bits(word: int) -> int:
    """A seed word as the int32 whose bits the kernels read as uint32."""
    return (word & _M32) - ((word & 0x80000000) << 1)


def block_uniform(seed0: int, seed1: int, block_id: int, rows: int, device) -> Callable:
    """The counter stream of one chain block, from call 1 on: each call
    returns one ``(rows,)`` float32 draw. Hashed ``_CALLS_PER_HASH`` calls
    at a time."""
    salt = counter_salt(seed0, seed1, block_id, rows, device)
    stream = {"calls": 0, "table": salt.new_empty((0, rows), dtype=torch.float32)}

    def uniform():
        c = stream["calls"]
        if c == stream["table"].shape[0]:
            nxt = torch.arange(c + 1, c + 1 + _CALLS_PER_HASH, device=salt.device)
            stream["table"] = torch.cat(
                [stream["table"], counter_uniform(salt[None, :], nxt[:, None])])
        stream["calls"] = c + 1
        return stream["table"][c]

    return uniform


def trajectory_plain(q, p, grad, logp, eps, max_depth_c, var, seed, *,
                     spec: TrajectorySpec, max_treedepth: int, Emax: float,
                     chain_block: int = DEFAULT_CHAIN_BLOCK,
                     integrator: str = "leapfrog",
                     metric: str = "diag") -> Dict[str, torch.Tensor]:
    """The plain PyTorch transition, block by block, on any device."""
    C = q.shape[0]
    cb = resolve_chain_block(C, chain_block)
    seed0, seed1 = _seed_words(seed)
    coeffs = INTEGRATOR_COEFFS[integrator]

    def model(x):
        return body_logp_grad(spec, x)

    outs = []
    for blk in range(C // cb):
        rows = slice(blk * cb, (blk + 1) * cb)
        vel = metric_velocity(var[rows] if metric == "diag" else var, metric)
        p0, lp0 = p[rows], logp[rows]
        E0 = 0.5 * _rowdot(p0, vel(p0)) - lp0
        outs.append(transition_block(
            model, vel, block_uniform(seed0, seed1, blk, cb, q.device), coeffs,
            float(Emax), max_treedepth, q[rows], p0, grad[rows], lp0, E0, eps[rows],
            max_depth_c[rows]))
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


# --------------------------------------------------------------------------
# The CUDA kernel's wrapper
# --------------------------------------------------------------------------

_OUT_F32 = ("energy", "logp", "log_size", "log_weighted_accept_sum",
            "max_energy_change")
_OUT_I32 = ("depth", "n_leaves")
_OUT_BOOL = ("diverging", "turning")


def _check_inputs(spec, q, p, grad, logp, eps, max_depth_c, var, metric):
    C, n = q.shape
    if n != spec.ndim:
        raise ValueError(f"q has {n} columns but the model has {spec.ndim}")
    if metric not in METRIC_IDS:
        raise ValueError(f"unknown metric {metric!r}; known: {sorted(METRIC_IDS)}")
    dev = q.device
    var_shape = (C, n) if metric == "diag" else (n, n)
    for name, t, shape, dtype in (
            ("q", q, (C, n), torch.float32), ("p", p, (C, n), torch.float32),
            ("grad", grad, (C, n), torch.float32), ("var", var, var_shape, torch.float32),
            ("logp", logp, (C,), torch.float32), ("eps", eps, (C,), torch.float32),
            ("max_depth_c", max_depth_c, (C,), torch.int32)):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for c in spec.consts:
        if c.device != dev or c.dtype != torch.float32 or not c.is_contiguous():
            raise ValueError("model constants must be contiguous float32 on "
                             f"{dev}; got {c.dtype} on {c.device}")


def _launch_kernel(q, p, grad, logp, eps, max_depth_c, var, seed, *, spec,
                   max_treedepth, Emax, chain_block, integrator, metric):
    from ._build import load_library

    C, n = q.shape
    cb = resolve_chain_block(C, chain_block)
    if cb > MAX_KERNEL_CHAIN_BLOCK:
        raise ValueError(f"chain_block {cb} exceeds the kernel's "
                         f"{MAX_KERNEL_CHAIN_BLOCK} chains per thread block")
    if (spec.body == "correlated_gaussian" or metric == "dense") and n > MAX_KERNEL_NDIM_DENSE:
        raise ValueError(f"the correlated_gaussian body and the dense metric take "
                         f"n <= {MAX_KERNEL_NDIM_DENSE}, got {n}")
    b_coef, a_coef = INTEGRATOR_COEFFS[integrator]
    coef = (ctypes.c_float * 7)(*(list(b_coef) + [0.0] * (4 - len(b_coef))
                                  + list(a_coef) + [0.0] * (3 - len(a_coef))))
    seed0, seed1 = _seed_words(seed)
    D = int(max_treedepth)

    out = {"q": torch.empty_like(q), "grad": torch.empty_like(q)}
    for k in _OUT_F32:
        out[k] = torch.empty(C, dtype=torch.float32, device=q.device)
    for k in _OUT_I32:
        out[k] = torch.empty(C, dtype=torch.int32, device=q.device)
    for k in _OUT_BOOL:
        out[k] = torch.empty(C, dtype=torch.bool, device=q.device)
    # merge stack: (left p, right p, p sum, proposal q) x D slots x C x n
    stack = torch.empty((4, D, C, n), dtype=torch.float32, device=q.device)
    consts = spec.consts[0].data_ptr() if spec.consts else 0

    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.nuts_trajectory_launch(
            q.data_ptr(), p.data_ptr(), grad.data_ptr(), var.data_ptr(),
            logp.data_ptr(), eps.data_ptr(), max_depth_c.data_ptr(),
            seed0 & 0xFFFFFFFF, seed1 & 0xFFFFFFFF,
            BODY_IDS[spec.body], METRIC_IDS[metric], consts,
            C, n, D, float(Emax), cb, len(a_coef), ctypes.cast(coef, ctypes.c_void_p),
            stack.data_ptr(),
            *(out[k].data_ptr() for k in ("q", "grad") + _OUT_F32 + _OUT_I32 + _OUT_BOOL),
            stream)
    if err != 0:
        raise RuntimeError(f"nuts_trajectory kernel launch failed: CUDA error "
                           f"{err} ({lib.cuda_error_string(err).decode()})")
    trajectory.launches += 1
    return out


def trajectory(q, p, grad, logp, eps, max_depth_c, var, seed, *,
               spec: TrajectorySpec, max_treedepth: int, Emax: float,
               chain_block: int = DEFAULT_CHAIN_BLOCK,
               integrator: str = "leapfrog",
               metric: str = "diag") -> Dict[str, torch.Tensor]:
    """One NUTS transition for every chain, where the tensors lie.

    Inputs: ``q, p, grad`` ``(C, n)`` float32; ``var`` the metric:
    ``(C, n)`` inverse-mass diagonals for ``metric="diag"``, one ``(n, n)``
    covariance for ``metric="dense"``; ``logp, eps`` ``(C,)`` float32,
    ``max_depth_c`` ``(C,)`` int32, ``seed`` an int or two int32 words.
    Returns the JAX op's dict (``nuts_trajectory_pallas.py:1045-1057``):
    proposal ``q``/``grad``/``energy``/``logp``, ``log_size``,
    ``log_weighted_accept_sum``, ``max_energy_change``, ``depth`` and
    ``n_leaves`` (int32), ``diverging`` and ``turning`` (bool).

    CPU tensors run :func:`trajectory_plain`; CUDA tensors launch the
    kernel (``trajectory.launches`` counts those launches) or raise.
    """
    _check_inputs(spec, q, p, grad, logp, eps, max_depth_c, var, metric)
    kw = dict(spec=spec, max_treedepth=max_treedepth, Emax=Emax,
              chain_block=chain_block, integrator=integrator, metric=metric)
    if q.device.type == "cpu":
        return trajectory_plain(q, p, grad, logp, eps, max_depth_c, var, seed, **kw)
    if q.device.type == "cuda":
        return _launch_kernel(q, p, grad, logp, eps, max_depth_c, var, seed, **kw)
    raise RuntimeError(f"no trajectory implementation for device {q.device}")


trajectory.launches = 0
