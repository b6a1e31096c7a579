"""One whole NUTS transition per chain: the trajectory op.

Counterpart of ``littlemcmc_tpu/ops/nuts_trajectory_pallas.py::
build_trajectory_op`` with ``metric="diag"``, ``"dense"`` or ``"lowrank"``
and ``pack=1``. One call builds each chain's whole tree: the merge stack,
the edge states and the proposal stay inside the op, and the model's
``(logp, grad)`` is inlined. The diag metric is a per-chain inverse-mass
diagonal (velocity ``var * p``); the dense metric is one ``(n, n)``
covariance shared by every chain (velocity ``p @ var``,
``make_velocities(V, "dense")``, ``nuts_trajectory_pallas.py:309-333``);
the low-rank metric is a per-chain scale ``S`` and one factor block shared
by every chain (velocity ``S(αx + V((λ−α)·(Vᵀx)))``, ``x = S p``;
``_make_lowrank_velocities``, ``:717-753``), laid out for the card by
:func:`build_lowrank_fac`.
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
from typing import Callable, Dict, Optional, Tuple

import torch

from ..integration import INTEGRATOR_COEFFS
from ..math import fp32_matmul
from .logistic import logistic_logp_grad_plain, pack_logistic
from .quadform import quadform_logp_grad_plain

__all__ = ["TrajectorySpec", "fmix32", "counter_salt", "counter_uniform",
           "resolve_chain_block", "trajectory", "trajectory_plain",
           "body_logp_grad", "DEFAULT_CHAIN_BLOCK", "METRIC_IDS", "LOWRANK_MAX_K",
           "lowrank_fac_size", "build_lowrank_fac", "warp_sum", "thin_dots",
           "runs_block_transition", "runs_hmc_block_transition", "fused_hmc_transition",
           "stack_shape"]

# Chains per CUDA thread block, one warp per chain: 128 blocks at the
# main path's 1024 chains for the card's 132 SMs. Bodies 0, 1, 2, 4 and 5
# with the diagonal metric, body 1 with the dense metric and body 4 with
# the low-rank metric run the block transition (csrc/nuts_transition.cuh)
# in blocks of up to 8 chains, the warp transition in larger ones.
DEFAULT_CHAIN_BLOCK = 8
# 16 warps of 32 threads at up to 128 registers fill an SM's 65,536; the
# low-rank metric's instances take 8 warps of up to 255 registers
MAX_KERNEL_CHAIN_BLOCK = 16
MAX_KERNEL_LOWRANK_CHAIN_BLOCK = 8
MAX_KERNEL_NDIM_DENSE = 256  # register tile of the dense and the logistic model bodies

# model bodies and metrics compiled into the kernels (ids match
# csrc/nuts_transition.cuh)
BODY_IDS = {"standard_normal": 0, "correlated_gaussian": 1, "eight_schools": 2, "logistic": 3,
            "spiked_gaussian": 4, "funnel": 5, "auto": 6}
METRIC_IDS = {"diag": 0, "dense": 1, "lowrank": 2}
# the bodies whose kDiag instances, those whose kDense instances and those
# whose kLowRank instances run the block transition in chain blocks of up
# to BLOCK_TRANSITION_CHAINS (block_body() and kBlockChains in
# csrc/nuts_transition.cuh)
BLOCK_TRANSITION_BODIES = ("standard_normal", "correlated_gaussian", "eight_schools",
                           "spiked_gaussian", "funnel")
BLOCK_TRANSITION_DENSE_BODIES = ("correlated_gaussian",)
BLOCK_TRANSITION_LOWRANK_BODIES = ("spiked_gaussian",)
BLOCK_TRANSITION_CHAINS = 8
# the bodies of the HMC kernels' block transition (hmc_block_body in
# csrc/hmc_transition.cuh): per draw with the diagonal metric, fused with
# the dense one
HMC_BLOCK_TRANSITION_BODIES = ("correlated_gaussian",)
# the fused HMC kernel's instances with the chain's state in registers
# (hmc_register_body and hmc_packed_body in csrc/hmc_transition.cuh): body
# 4 with the low-rank metric, one warp a chain, in chain blocks of up to
# BLOCK_TRANSITION_CHAINS at n <= HMC_REGISTER_MAX_N (32 kRegTrips); eight
# schools with the diagonal metric, several chains a warp, at any chain
# block
HMC_REGISTER_INSTANCES = {("spiked_gaussian", "lowrank"): "registers",
                          ("eight_schools", "diag"): "packed"}
HMC_REGISTER_MAX_N = 128
# columns of the low-rank factor block the kernels read (kMaxRank in
# csrc/nuts_transition.cuh); a smaller rank is padded with zero columns
LOWRANK_MAX_K = 8

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
    ``logistic``: Bayesian logistic regression over ``N`` data rows
    (``models/logistic.py:90-136``); the design ``Xb`` ``(N, n)`` with the
    intercept folded in, the responses ``y`` ``(N,)`` and the prior
    precision ``1/prior_scale^2`` ``(1,)``, all fp32 and unpadded;
    ``logp = sum(y * logits - softplus(logits)) - prior_prec q.q/2``.
    ``spiked_gaussian``: the zero-mean Gaussian with covariance
    ``S(I + V(Λ−I)Vᵀ)S`` (``models/gaussian.py:140-237``); ``V`` ``(n, k)``
    with ``k <= 8``, ``1/λ − 1`` ``(k,)`` and ``1/s`` ``(n,)``;
    ``g = −S⁻¹(x + V((1/λ−1)·(Vᵀx)))``, ``x = S⁻¹q``, ``logp = q.g/2``.
    ``funnel``: Neal's centred funnel (``models/funnel.py:54-86``), ``q =
    [v, x]``; one ``(1,)`` fp32 constant ``[1/scale^2]``; ``sq =
    sum_{i>=1} x_i^2`` summed on its own, ``logp = -v^2/(2 s^2) -
    (n-1) v/2 - exp(-v) sq/2``.
    ``auto``: a body generated from a traced user model
    (:mod:`~littlemcmc_torch.ops.autospec`); ``auto`` holds the program
    (its IR, the CUDA source and the traced graph, the plain version),
    ``consts`` the model's constants flattened to float32 (index tensors
    as int32 bits).

    ``packable``: the JAX model's spec has a lane-packed body
    (``packed_fn``). Nothing in the port packs lanes; the flag only
    takes part in the engine election, as ``resolve_pack`` does there.

    ``kernel_consts`` is what the CUDA kernels read: the one constant, or
    for the logistic body its three packed into one contiguous buffer
    (:func:`~littlemcmc_torch.ops.logistic.pack_logistic`), for the spiked
    Gaussian ``[Vᵀ (k x n), 1/λ − 1, 1/s]`` in one buffer, or None for a
    body without constants, for the funnel ``[1/scale^2]`` and for a
    generated body its constants packed into one buffer; ``rows`` is the
    logistic body's ``N``, the spiked Gaussian's ``k`` and a generated
    body's count of constant floats (0 for the others).
    """

    body: str
    consts: Tuple[torch.Tensor, ...]
    ndim: int
    packable: bool = False
    auto: Optional[object] = dataclasses.field(default=None, repr=False)
    kernel_consts: Optional[torch.Tensor] = dataclasses.field(init=False, repr=False)
    rows: int = dataclasses.field(init=False)

    def __post_init__(self):
        if self.body not in BODY_IDS:
            raise ValueError(f"unknown model body {self.body!r}; "
                             f"known: {sorted(BODY_IDS)}")
        if (self.auto is not None) != (self.body == "auto"):
            raise ValueError("a generated body, and only it, carries its program (auto=)")
        if self.body == "eight_schools" and self.ndim != 10:
            raise ValueError(f"the eight_schools body has 10 parameters, not {self.ndim}")
        got = [tuple(c.shape) for c in self.consts]
        rows = 0
        if self.body == "logistic" and got and got[0]:
            rows = got[0][0]
        elif self.body == "spiked_gaussian" and got and len(got[0]) == 2:
            rows = got[0][1]
        elif self.body == "auto":
            rows = sum(c.numel() for c in self.consts)
        want = {"standard_normal": [], "correlated_gaussian": [(self.ndim, self.ndim)],
                "eight_schools": [(2, 10)],
                "logistic": [(rows, self.ndim), (rows,), (1,)],
                "spiked_gaussian": [(self.ndim, rows), (rows,), (self.ndim,)],
                "funnel": [(1,)],
                "auto": [(c.numel(),) for c in self.consts]}[self.body]
        if (got != want or (self.body == "logistic" and rows < 1)
                or (self.body == "spiked_gaussian" and not 1 <= rows <= LOWRANK_MAX_K)):
            raise ValueError(f"the {self.body} body takes constants of shapes {want}, got "
                             f"{got}" + (f" (k <= {LOWRANK_MAX_K})"
                                         if self.body == "spiked_gaussian" else ""))
        if self.body == "logistic":
            packed = pack_logistic(*self.consts)
        elif self.body == "spiked_gaussian":
            V, il, inv_s = self.consts
            packed = torch.cat([V.T.reshape(-1), il, inv_s]).contiguous()
        elif self.body == "auto":
            packed = torch.cat(self.consts).contiguous() if self.consts else None
        else:
            packed = self.consts[0] if self.consts else None
        object.__setattr__(self, "kernel_consts", packed)
        object.__setattr__(self, "rows", rows)


def body_logp_grad(spec: TrajectorySpec, q: torch.Tensor):
    """The body's plain ``(logp (C,), grad (C, n))`` at ``q (C, n)``: the
    plain versions of the batched model kernels for the correlated
    Gaussian (:func:`~littlemcmc_torch.ops.quadform.quadform_logp_grad_plain`)
    and the logistic regression
    (:func:`~littlemcmc_torch.ops.logistic.logistic_logp_grad_plain`)."""
    if spec.body == "standard_normal":
        return -0.5 * (q * q).sum(1), -q
    if spec.body == "eight_schools":
        return _eight_schools_logp_grad(spec.consts[0], q)
    if spec.body == "logistic":
        return logistic_logp_grad_plain(q, *spec.consts)
    if spec.body == "spiked_gaussian":
        return _spiked_logp_grad(*spec.consts, q)
    if spec.body == "funnel":
        return _funnel_logp_grad(spec.consts[0], q)
    if spec.body == "auto":
        return spec.auto.plain(q)
    return quadform_logp_grad_plain(q, spec.consts[0])


# the lane each lane of a warp reads at each step of an xor butterfly
_XOR_LANES = {o: torch.arange(32) ^ o for o in (16, 8, 4, 2, 1)}


def warp_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis in the kernels' order: lane ``l`` adds
    elements ``l, l + 32, ...`` in turn, then an xor butterfly over the 32
    lanes (``warp_sum`` of ``csrc/nuts_transition.cuh``), so that a plain
    version and a kernel round the same thin products to the same bits."""
    n = x.shape[-1]
    x = torch.nn.functional.pad(x, (0, (-n) % 32))
    chunks = x.reshape(*x.shape[:-1], -1, 32)
    part = chunks[..., 0, :] + 0.0
    for c in range(1, chunks.shape[-2]):
        part = part + chunks[..., c, :]
    for o, lanes in _XOR_LANES.items():
        part = part + part[..., lanes.to(part.device)]
    return part[..., 0]


def thin_dots(x: torch.Tensor, Vt: torch.Tensor) -> torch.Tensor:
    """``Vᵀx`` for ``x`` ``(..., n)`` and ``Vt`` ``(k, n)``: ``(..., k)``,
    each of the ``k`` dots a :func:`warp_sum` (the kernels' ``thin_dots``)."""
    return warp_sum(x[..., None, :] * Vt)


def thin_combine(Vt: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``V d`` for ``Vt`` ``(k, n)`` and ``d`` ``(..., k)``: the columns
    added in turn from 0, as the kernels add them."""
    acc = torch.zeros(d.shape[:-1] + Vt.shape[1:], dtype=d.dtype, device=d.device)
    for j in range(Vt.shape[0]):
        acc = acc + Vt[j] * d[..., j:j + 1]
    return acc


def _spiked_logp_grad(V: torch.Tensor, il: torch.Tensor, inv_s: torch.Tensor,
                      q: torch.Tensor):
    """The spiked Gaussian's body (``models/gaussian.py:204-237``) with the
    kernels' sums: ``x = q/s``, ``g = −(x + V((1/λ−1)·(Vᵀx)))/s``,
    ``logp = q.g/2``."""
    Vt = V.T
    x = q * inv_s
    y = x + thin_combine(Vt, thin_dots(x, Vt) * il)
    g = -y * inv_s
    return 0.5 * warp_sum(q * g), g


def _funnel_logp_grad(inv_s2: torch.Tensor, q: torch.Tensor):
    """The centred funnel's body in the kernels' order: ``sq`` a
    :func:`warp_sum` over columns 1.. only, then ``logp`` and ``grad`` as
    ``model_eval<5>`` of ``csrc/nuts_transition.cuh`` evaluates them."""
    v = q[:, 0]
    x = q[:, 1:]
    sq = warp_sum(torch.cat([torch.zeros_like(q[:, :1]), x * x], 1))
    e = torch.exp(-v)
    nx = float(q.shape[1] - 1)
    s = inv_s2[0]
    logp = (-0.5 * s) * v * v - (0.5 * nx) * v - (0.5 * sq) * e
    dv = (-s) * v - 0.5 * nx + (0.5 * sq) * e
    return logp, torch.cat([dv[:, None], (-x) * e[:, None]], 1)


def lowrank_fac_size(n: int) -> int:
    """Floats of the low-rank factor block the kernels read (the card's
    layout of ``lowrank_fac_rows``, ``nuts_trajectory_pallas.py:699``):
    ``Vᵀ`` as 8 rows of ``n``, then ``λ − α`` and ``λ^{−½} − α^{−½}`` (8
    each, zero past the rank), then ``α`` and ``α^{−½}``."""
    return LOWRANK_MAX_K * (n + 2) + 2


def build_lowrank_fac(V: torch.Tensor, lam: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """The factor block of :func:`lowrank_fac_size` from one basis ``V``
    ``(n, k)`` (``k <= 8``), its eigenvalues ``lam`` ``(k,)`` and the bulk
    ``alpha`` (``build_lowrank_fac``, ``nuts_trajectory_pallas.py:706``).
    The coefficients are computed here once, in float32, so the kernels and
    their plain versions read the same bits."""
    n, k = V.shape
    if k > LOWRANK_MAX_K:
        raise ValueError(f"the kernels take a low-rank metric of rank <= {LOWRANK_MAX_K}, "
                         f"got {k}")
    K = LOWRANK_MAX_K
    f = dict(dtype=torch.float32, device=V.device)
    Vt = torch.zeros(K, n, **f)
    Vt[:k] = V.T
    a = alpha.to(torch.float32).reshape(1)
    ah = a ** -0.5
    cvel, cmom = torch.zeros(K, **f), torch.zeros(K, **f)
    cvel[:k] = lam - a
    cmom[:k] = lam ** -0.5 - ah
    return torch.cat([Vt.reshape(-1), cvel, cmom, a, ah]).contiguous()


def lowrank_fac_parts(fac: torch.Tensor, n: int):
    """``(Vt (8, n), λ − α, λ^{−½} − α^{−½}, α, α^{−½})`` of a factor block."""
    K = LOWRANK_MAX_K
    Vt = fac[:K * n].reshape(K, n)
    return Vt, fac[K * n:K * n + K], fac[K * n + K:K * n + 2 * K], fac[-2], fac[-1]


def lowrank_velocity(stds: torch.Tensor, fac: torch.Tensor) -> Callable:
    """``p -> S(αx + V((λ−α)·(Vᵀx)))`` with ``x = S p`` (``stds`` the rows'
    ``S``), in the kernels' order of operations."""
    Vt, cvel, _, alpha, _ = lowrank_fac_parts(fac, stds.shape[-1])

    def vel(p):
        x = stds * p
        return stds * (alpha * x + thin_combine(Vt, thin_dots(x, Vt) * cvel))

    return vel


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


def runs_block_transition(body: str, metric: str, chain_block: int) -> bool:
    """Whether the NUTS kernels' instance for ``body`` and ``metric`` at
    ``chain_block`` chains a block runs ``block_transition`` (else the warp
    ``transition``): the predicate of the kernels' launch, which also runs
    the warp transition for body 4 where its constants do not fit in shared
    memory beside the working vectors (a few dozen n below the largest the
    kernels take; with the low-rank metric, whose body-4 instance has no
    warp transition, it refuses such a launch)."""
    bodies = {"diag": BLOCK_TRANSITION_BODIES, "dense": BLOCK_TRANSITION_DENSE_BODIES,
              "lowrank": BLOCK_TRANSITION_LOWRANK_BODIES}
    return body in bodies.get(metric, ()) and chain_block <= BLOCK_TRANSITION_CHAINS


def runs_hmc_block_transition(body: str, metric: str, chain_block: int, fused: bool) -> bool:
    """Whether the HMC kernels' instance for ``body`` and ``metric`` runs
    the block HMC transition of ``csrc/hmc_transition.cuh`` (else each
    warp integrates its chain on its own): the per-draw kernel's body 1
    with the diagonal metric at any chain block (its thread blocks are not
    its counter stream's, ``kHmcBlockChains``), and the fused kernel's
    body 1 with the dense metric in chain blocks of up to
    ``BLOCK_TRANSITION_CHAINS`` (``hmc_block_body`` in the kernels'
    launch)."""
    if body not in HMC_BLOCK_TRANSITION_BODIES:
        return False
    if fused:
        return metric == "dense" and chain_block <= BLOCK_TRANSITION_CHAINS
    return metric == "diag"


def fused_hmc_transition(body: str, metric: str, chain_block: int, n: int) -> str:
    """The transition the fused HMC kernel's instance for ``body`` and
    ``metric`` runs at ``chain_block`` chains a block and ``n`` columns
    (``launch`` in ``csrc/fused_hmc.cu``): ``"block"``, the block HMC
    transition (:func:`runs_hmc_block_transition`); ``"registers"``, one
    warp a chain with its vectors in registers; ``"packed"``, several chains
    a warp in registers; else ``"warp"``, one warp a chain on shared
    memory."""
    if runs_hmc_block_transition(body, metric, chain_block, fused=True):
        return "block"
    kind = HMC_REGISTER_INSTANCES.get((body, metric))
    if kind == "registers" and (chain_block > BLOCK_TRANSITION_CHAINS
                                or n > HMC_REGISTER_MAX_N):
        return "warp"
    return kind or "warp"


def stack_shape(body: str, metric: str, chain_block: int, D: int, C: int, n: int):
    """The NUTS kernels' global merge stack for a launch: ``D`` slots of
    ``C`` chains' left p, right p, p sum and proposal q (``n`` floats
    each), and where the block transition runs the dense or the low-rank
    metric the left and right p's velocities too (``slot_vecs`` in
    csrc/nuts_transition.cuh)."""
    cached = metric != "diag" and runs_block_transition(body, metric, chain_block)
    return (6 if cached else 4, D, C, n)


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


def metric_velocity(var, metric: str, fac: Optional[torch.Tensor] = None) -> Callable:
    """The velocity ``p -> M^{-1} p`` of a metric: ``var * p`` for a
    per-chain diagonal, ``p @ var`` for a shared dense covariance, and for
    the low-rank metric (``var`` the chains' scales, ``fac`` the factor
    block) :func:`lowrank_velocity`."""
    if metric == "diag":
        return lambda p: var * p
    if metric == "dense":
        return lambda p: fp32_matmul(p, var)
    if metric == "lowrank":
        return lowrank_velocity(var, fac)
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


def shard_seed(seed, block0: int):
    """The seed of a launch on a shard whose first chain block is global
    block ``block0``, so each chain draws the stream it draws in the
    unsharded launch. Every kernel and plain version reads its first seed
    word only as ``seed0 + block*7919`` (mod 2^32, ``counter_salt`` and
    each ``.cu`` file's salts), so adding ``block0*7919`` to that word
    salts local block ``b`` as global block ``block0 + b``; ``block0 = 0``
    leaves the seed as it is."""
    if not block0:
        return seed
    w0, w1 = _seed_words(seed)
    return ((w0 + int(block0) * 7919) & _M32, w1)


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
                     integrator: str = "leapfrog", metric: str = "diag",
                     fac: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
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
        vel = metric_velocity(var if metric == "dense" else var[rows], metric, fac)
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


def _check_inputs(spec, q, p, grad, logp, eps, max_depth_c, var, metric, fac):
    C, n = q.shape
    if n != spec.ndim:
        raise ValueError(f"q has {n} columns but the model has {spec.ndim}")
    if metric not in METRIC_IDS:
        raise ValueError(f"unknown metric {metric!r}; known: {sorted(METRIC_IDS)}")
    if (fac is not None) != (metric == "lowrank"):
        raise ValueError("the low-rank metric, and only it, takes the factor block fac")
    dev = q.device
    metric_in = (("var", var, (n, n) if metric == "dense" else (C, n)),)
    if metric == "lowrank":
        metric_in += (("fac", fac, (lowrank_fac_size(n),)),)
    for name, t, shape, dtype in (
            ("q", q, (C, n), torch.float32), ("p", p, (C, n), torch.float32),
            ("grad", grad, (C, n), torch.float32),
            *((k, t, sh, torch.float32) for k, t, sh in metric_in),
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


def kernel_chain_block(C: int, chain_block: int, metric: str) -> int:
    """The NUTS kernels' chain block for ``C`` chains, after checking that
    a thread block takes it: at most 16 chains, 8 for the low-rank metric."""
    cb = resolve_chain_block(C, chain_block)
    most = MAX_KERNEL_LOWRANK_CHAIN_BLOCK if metric == "lowrank" else MAX_KERNEL_CHAIN_BLOCK
    if cb > most:
        raise ValueError(f"chain_block {cb} exceeds the kernel's {most} chains per thread "
                         f"block (metric {metric!r})")
    return cb


def kernel_library(name: str, spec: TrajectorySpec, device, warps: int):
    """The library whose kernel ``name`` a launch with ``spec``'s body
    runs: the sources' build, or for a generated body its own build
    (:func:`~littlemcmc_torch.ops.autospec.kernel_library`, which probes
    the body first and binds its scratch for ``warps`` warps)."""
    if spec.body == "auto":
        from .autospec import kernel_library as generated_library

        return generated_library(spec, name, device, warps)
    from ._build import load_library

    return load_library(name)


def _launch_kernel(q, p, grad, logp, eps, max_depth_c, var, seed, *, spec,
                   max_treedepth, Emax, chain_block, integrator, metric, fac):
    C, n = q.shape
    cb = kernel_chain_block(C, chain_block, metric)
    if (spec.body in ("correlated_gaussian", "logistic") or metric == "dense") \
            and n > MAX_KERNEL_NDIM_DENSE:
        raise ValueError(f"the {spec.body} body and the dense metric take "
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
    # merge stack (the block transition keeps its lower slots in shared
    # memory and uses this for the rest)
    stack = torch.empty(stack_shape(spec.body, metric, cb, D, C, n), dtype=torch.float32,
                        device=q.device)
    consts = spec.kernel_consts.data_ptr() if spec.kernel_consts is not None else 0

    lib = kernel_library("nuts_trajectory", spec, q.device, C)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.nuts_trajectory_launch(
            q.data_ptr(), p.data_ptr(), grad.data_ptr(), var.data_ptr(),
            fac.data_ptr() if fac is not None else 0,
            logp.data_ptr(), eps.data_ptr(), max_depth_c.data_ptr(),
            seed0 & 0xFFFFFFFF, seed1 & 0xFFFFFFFF,
            BODY_IDS[spec.body], METRIC_IDS[metric], consts, spec.rows,
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
               integrator: str = "leapfrog", metric: str = "diag",
               fac: Optional[torch.Tensor] = None, block0: int = 0) -> Dict[str, torch.Tensor]:
    """One NUTS transition for every chain, where the tensors lie.

    Inputs: ``q, p, grad`` ``(C, n)`` float32; ``var`` the metric:
    ``(C, n)`` inverse-mass diagonals for ``metric="diag"``, one ``(n, n)``
    covariance for ``metric="dense"``, and for ``metric="lowrank"`` the
    chains' scales ``(C, n)``, with ``fac`` the shared factor block of
    :func:`build_lowrank_fac`; ``logp, eps`` ``(C,)`` float32,
    ``max_depth_c`` ``(C,)`` int32, ``seed`` an int or two int32 words.
    Returns the JAX op's dict (``nuts_trajectory_pallas.py:1045-1057``):
    proposal ``q``/``grad``/``energy``/``logp``, ``log_size``,
    ``log_weighted_accept_sum``, ``max_energy_change``, ``depth`` and
    ``n_leaves`` (int32), ``diverging`` and ``turning`` (bool).
    ``block0``: the global index of the first chain block of a shard of
    the chains (:func:`shard_seed`).

    CPU tensors run :func:`trajectory_plain`; CUDA tensors launch the
    kernel (``trajectory.launches`` counts those launches) or raise.
    """
    _check_inputs(spec, q, p, grad, logp, eps, max_depth_c, var, metric, fac)
    seed = shard_seed(seed, block0)
    kw = dict(spec=spec, max_treedepth=max_treedepth, Emax=Emax,
              chain_block=chain_block, integrator=integrator, metric=metric, fac=fac)
    if q.device.type == "cpu":
        return trajectory_plain(q, p, grad, logp, eps, max_depth_c, var, seed, **kw)
    if q.device.type == "cuda":
        return _launch_kernel(q, p, grad, logp, eps, max_depth_c, var, seed, **kw)
    raise RuntimeError(f"no trajectory implementation for device {q.device}")


trajectory.launches = 0
