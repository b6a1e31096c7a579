"""T NUTS transitions per call: the fused op, for a shared dense metric, a
per-chain inverse-mass diagonal or the pooled low-rank metric.

Counterpart of ``littlemcmc_tpu/ops/fused_nuts_pallas.py::
build_fused_nuts_op`` with ``metric="dense"``, static (draw chunks) and
with ``adapt_dense`` (pooled dense adaptation inside tune chunks), with
``metric="diag"``, static and with ``adapt_metric`` (per-chain diag
adaptation inside tune chunks), and with ``metric="lowrank"``: per-chain
variance rows, adapted per chain in tune chunks as the diag ones, and one
factor block frozen for the chunk (``:493-531``, ``:669-710``). One call
runs ``T`` transitions for every chain with the chain state kept inside
the op, and per draw:

- the momentum from Box-Muller normals ``z`` of the counter stream
  (``_boxmuller_std`` ``:134``): ``p = z @ L^{-1}`` (``_dense_momentum``
  ``:154``), ``p = z / sqrt(V)`` (``_boxmuller_momentum`` ``:143``) or
  ``p = (α^{−½}z + V((λ^{−½}−α^{−½})·(Vᵀz))) / sqrt(V)``
  (``_lowrank_momentum`` ``:169``);
- the step size and early depth cap from the iteration counter;
- one transition (:func:`.nuts_trajectory.transition_block`, velocity
  ``p @ cov``, ``V p`` or the low-rank one of
  :func:`.nuts_trajectory.lowrank_velocity` with ``S = sqrt(V)``) and the
  proposal's gradient;
- ``mean_tree_accept`` and dual averaging (``_da_update_cols`` ``:399``);
- in tune chunks with ``welford`` (diag), each chain's dual-window Welford
  step on its proposal, which refreshes ``V`` for the next draw from the
  pre-swap foreground (``_welford_update_rows`` ``:418-458``);
- with ``adapt_dense``, the block-local pooled Welford adds of the block's
  new positions to both windows and the shared window swap
  (``_dense_welford_batch_add`` ``:246``, ``_dense_welford_swap_and_count``
  ``:267``), each block seeded with 1/B of the global pooled state
  (``_adapt_dense_inputs`` ``:293-325``);
- the trace row and the per-draw stats.

Two implementations compute the same function: :func:`fused_nuts_plain`,
plain PyTorch, block by block in lockstep, for CPU tensors and as the
yardstick; and the CUDA kernel ``csrc/fused_nuts.cu`` for CUDA tensors.
:func:`fused_nuts` picks by the tensors' device and never falls back.
:func:`combine_dense_welford` Chan-combines the per-block Welford states
outside the op, as in the JAX package.

Randomness: per draw ``t`` of block ``i`` the seed word is
``seed0 = w0 + i*7919 + t*15485863`` (``:662``); the transition draws the
block's counter stream salted with ``seed0`` and the momentum draws the
stream salted ``seed0 + 1013904223`` with per-element lanes
``row * Npad + col`` (``:700-705``, ``nuts_trajectory_pallas.py:354-358``),
``Npad = padded_dim(n)``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from ..integration import INTEGRATOR_COEFFS
from ..math import fp32_matmul, round_up
from .nuts_trajectory import (kernel_library, BODY_IDS, DEFAULT_CHAIN_BLOCK, MAX_KERNEL_NDIM_DENSE, METRIC_IDS, TrajectorySpec, _M32, _GOLDEN,
                              _rowdot, _seed_words, block_uniform, body_logp_grad,
                              counter_uniform, fmix32, int32_bits, kernel_chain_block,
                              lowrank_fac_parts, stack_shape,
                              lowrank_fac_size, lowrank_velocity, metric_velocity,
                              resolve_chain_block, thin_combine, thin_dots, transition_block)

__all__ = ["fused_nuts", "fused_nuts_plain", "combine_dense_welford", "padded_dim",
           "dense_momentum", "diag_momentum", "lowrank_momentum", "STAT_KEYS",
           "WELFORD_KEYS"]

_TWO_PI = 6.283185307179586
_MOMENTUM_SALT = 1013904223
_DRAW_STRIDE = 15485863

# per-draw stats the op returns, each (T, C)
STAT_KEYS = ("energy", "model_logp", "energy_error", "mean_tree_accept", "step_size",
             "step_size_bar", "max_energy_change", "depth", "n_leaves", "diverging",
             "turning")
_STAT_F32 = STAT_KEYS[:7]  # order of the kernel's f32 stats
# the per-chain scalar state, columns 0-6 of the kernel's (C, 16) in/out
_SCALARS = ("logp", "iter_count", "da_log_step", "da_log_bar", "da_hbar", "da_count",
            "da_mu")
# the per-chain diag Welford state (``welford``), in the JAX op's order
# (``fused_nuts_pallas.py:800-802``): rows (C, n) and columns (C,)
WELFORD_KEYS = ("fg_mean", "fg_raw", "fg_w", "fg_w2", "bg_mean", "bg_raw", "bg_w", "bg_w2",
                "n_samples", "window")
_WELFORD_ROWS = ("fg_mean", "fg_raw", "bg_mean", "bg_raw")  # kernel's kVar rows 1-4
_WELFORD_COLS = ("fg_w", "fg_w2", "bg_w", "bg_w2", "n_samples", "window")  # columns 8-13
_N_SCAL = 16
# the block Welford state's per-block outputs, (B, ...) each
_WELFORD_KEYS = ("dense_fg_mean", "dense_fg_raw", "dense_fg_w", "dense_bg_mean",
                 "dense_bg_raw", "dense_bg_w")
_WELFORD_PTRS = ("welford_seed", "dense_fg_mean", "dense_fg_raw", "dense_bg_mean",
                 "dense_bg_raw", "welford_out")
# the kernel's pointer, int and float arguments, in the order of
# csrc/fused_nuts.cu
_PTRS = ("q", "grad", "scal", "cov", "linv", "var", "consts", "stack", "q_out", "grad_out",
         "scal_out", "var_out", "trace", "stat_f", "stat_i", "stat_b") + _WELFORD_PTRS
_INTS = ("C", "n", "D", "T", "cb", "n_stages", "body", "metric", "tuning", "adapting",
         "adapt_metric", "adapt_dense", "early_window", "early_max", "max_depth", "seed0",
         "seed1", "Npad", "rows")
_FLOATS = ("Emax", "b0", "b1", "b2", "b3", "a0", "a1", "a2", "target_accept", "gamma",
           "k", "t0", "window_multiplier")


def padded_dim(n: int) -> int:
    """The TPU kernel's padded row width for ``n`` parameters (``n`` plus
    four slot scalars, rounded up to 128 lanes): the momentum stream's
    lanes are numbered ``row * padded_dim(n) + col``."""
    return round_up(n + 4, 128)


# --------------------------------------------------------------------------
# Helpers the op runs per draw
# --------------------------------------------------------------------------

def boxmuller_normals(seed0: int, seed1: int, block_id: int, rows: int, n: int, device,
                      offset: int = _MOMENTUM_SALT) -> torch.Tensor:
    """The ``(rows, n)`` Box-Muller normals of one chain block's momentum
    draw: calls 1 and 2 of the row stream salted ``seed0 + offset``.
    ``seed0`` is the draw's seed word before the block offset; the NUTS
    kernel's stream ``offset`` is 1013904223, the HMC kernel's 0."""
    lanes = (torch.arange(rows, dtype=torch.int64, device=device)[:, None] * padded_dim(n)
             + torch.arange(n, dtype=torch.int64, device=device)[None, :])
    base = seed0 + block_id * 7919 + offset
    s1 = ((seed1 & _M32) * _GOLDEN) & _M32
    salt = fmix32(((base + lanes * 65063 + 17) & _M32) ^ s1)
    u1, u2 = counter_uniform(salt, 1), counter_uniform(salt, 2)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)


def dense_momentum(seed0: int, seed1: int, block_id: int, rows: int,
                   linv: torch.Tensor, offset: int = _MOMENTUM_SALT) -> torch.Tensor:
    """The momentum ``p = z @ L^{-1}`` of one chain block."""
    z = boxmuller_normals(seed0, seed1, block_id, rows, linv.shape[0], linv.device, offset)
    return fp32_matmul(z, linv)


def diag_momentum(seed0: int, seed1: int, block_id: int, var: torch.Tensor,
                  offset: int = _MOMENTUM_SALT) -> torch.Tensor:
    """The momentum ``p = z / sqrt(V)`` of one chain block whose
    inverse-mass diagonals are the rows of ``var``."""
    rows, n = var.shape
    return boxmuller_normals(seed0, seed1, block_id, rows, n, var.device, offset) / torch.sqrt(var)


def lowrank_momentum(seed0: int, seed1: int, block_id: int, stds: torch.Tensor,
                     fac: torch.Tensor, offset: int = _MOMENTUM_SALT) -> torch.Tensor:
    """The momentum ``p = S⁻¹(α^{−½}z + V((λ^{−½}−α^{−½})·(Vᵀz)))`` of one
    chain block whose scales are the rows of ``stds``, from the factor
    block ``fac`` (``_lowrank_momentum``, ``fused_nuts_pallas.py:169-192``),
    in the kernels' order of operations."""
    rows, n = stds.shape
    z = boxmuller_normals(seed0, seed1, block_id, rows, n, stds.device, offset)
    Vt, _, cmom, _, ah = lowrank_fac_parts(fac, n)
    return (ah * z + thin_combine(Vt, thin_dots(z, Vt) * cmom)) / stds


def momentum_and_velocity(metric: str, seed0: int, seed1: int, blk: int, rows: int, vb,
                          linv, fac, offset: int = _MOMENTUM_SALT):
    """One chain block's momentum draw (``rows`` chains) and velocity for
    its metric: ``vb`` is the block's rows of the per-chain variances (diag,
    low-rank) or the shared covariance (dense)."""
    if metric == "dense":
        return (dense_momentum(seed0, seed1, blk, rows, linv, offset),
                metric_velocity(vb, metric))
    if metric == "lowrank":
        stds = torch.sqrt(vb)
        return (lowrank_momentum(seed0, seed1, blk, stds, fac, offset),
                lowrank_velocity(stds, fac))
    return diag_momentum(seed0, seed1, blk, vb, offset), metric_velocity(vb, metric)


def _log1mexp(x: torch.Tensor) -> torch.Tensor:
    """``log(1 - exp(-x))`` for ``x > 0`` by the fused JAX kernel's formula
    (``fused_nuts_pallas.py:113-131``)."""
    small = x < 0.683
    safe_small = torch.where(small, x, torch.ones_like(x))
    safe_large = torch.where(small, torch.ones_like(x), x)
    tiny = torch.log(torch.clamp(safe_small, min=1e-30)) - 0.5 * safe_small
    mid = torch.log(torch.clamp(1.0 - torch.exp(-safe_small), min=1e-30))
    return torch.where(small, torch.where(x < 1e-4, tiny, mid),
                       torch.log(1.0 - torch.exp(-safe_large)))


def mean_tree_accept(log_size: torch.Tensor, lwas: torch.Tensor) -> torch.Tensor:
    """``exp(lwas - log(exp(log_size) - 1))``, 0 for a one-leaf tree."""
    return torch.where(log_size > 0, torch.exp(lwas - (log_size + _log1mexp(log_size))),
                       torch.zeros_like(log_size))


def _da_update(s: Dict[str, torch.Tensor], mta: torch.Tensor, config) -> None:
    """Dual averaging in place on the op's float32 columns
    (``_da_update_cols``, ``fused_nuts_pallas.py:399-415``)."""
    cnt = s["da_count"]
    w = 1.0 / (cnt + float(config.t0))
    hb = (1.0 - w) * s["da_hbar"] + w * (float(config.target_accept) - mta)
    ls_new = s["da_mu"] - hb * torch.sqrt(cnt) / float(config.gamma)
    mk = torch.exp(-float(config.k) * torch.log(cnt))
    s["da_log_bar"] = mk * ls_new + (1.0 - mk) * s["da_log_bar"]
    s["da_hbar"], s["da_log_step"], s["da_count"] = hb, ls_new, cnt + 1.0


class DiagWelford:
    """The per-chain dual-window diag Welford state of a set of chains, in
    the arithmetic of ``_welford_update_rows`` (``fused_nuts_pallas.py:
    418-458``) and of the kernels' ``DiagWelford``: float32 weights and
    counters per chain, the window swap at ``pn - win floor(pn / win) ==
    0``."""

    def __init__(self, welford: Sequence[torch.Tensor]):
        self.leaves = dict(zip(WELFORD_KEYS, welford))

    def rows(self, rows: slice) -> "DiagWelford":
        return DiagWelford([self.leaves[k][rows] for k in WELFORD_KEYS])

    def update(self, x: torch.Tensor, mult: float) -> torch.Tensor:
        """Add ``x`` to both windows, swap where a window ends; returns the
        variance of the pre-swap foreground, the next draw's metric."""
        s = self.leaves
        fw, bw = s["fg_w"] + 1.0, s["bg_w"] + 1.0
        rf, rb = (1.0 / fw)[:, None], (1.0 / bw)[:, None]
        pn, win = s["n_samples"], s["window"]
        # float modulo via floor: the counts stay far below 2^24 (exact)
        swap = (pn > 0) & ((pn - win * torch.floor(pn / win)) == 0)
        old = x - s["fg_mean"]
        fmean = s["fg_mean"] + rf * old
        fraw = s["fg_raw"] + old * (x - fmean)
        bold = x - s["bg_mean"]
        bmean = s["bg_mean"] + rb * bold
        braw = s["bg_raw"] + bold * (x - bmean)
        var = fraw * rf
        sw = swap[:, None]
        zero = torch.zeros_like(fw)
        s.update(fg_mean=torch.where(sw, bmean, fmean), fg_raw=torch.where(sw, braw, fraw),
                 bg_mean=torch.where(sw, torch.zeros_like(bmean), bmean),
                 bg_raw=torch.where(sw, torch.zeros_like(braw), braw),
                 fg_w=torch.where(swap, bw, fw),
                 fg_w2=torch.where(swap, s["bg_w2"] + 1.0, s["fg_w2"] + 1.0),
                 bg_w=torch.where(swap, zero, bw),
                 bg_w2=torch.where(swap, zero, s["bg_w2"] + 1.0),
                 window=torch.where(swap, torch.floor(win * mult), win), n_samples=pn + 1.0)
        return var


class _BlockWelford:
    """One chain block's pooled dense Welford state (both windows and the
    shared counters), seeded with 1/B of the global pooled state."""

    def __init__(self, dense_welford, B: int):
        fgm, fgr, fgw, bgm, bgr, bgw, ns, pu, win = dense_welford
        self.fg = [fgm.clone(), fgr / float(B), fgw / float(B)]
        self.bg = [bgm.clone(), bgr / float(B), bgw / float(B)]
        self.ns, self.pu, self.win = float(ns), float(pu), float(win)

    def add_batch(self, x: torch.Tensor) -> None:
        """Chan-combine the ``(RW, n)`` batch ``x`` into both windows
        (``_dense_welford_batch_add``)."""
        RWf = float(x.shape[0])
        xm = torch.sum(x, dim=0) * (1.0 / RWf)
        xc = x - xm
        raw_b = fp32_matmul(xc.T, xc)
        for win in (self.fg, self.bg):
            m, r, W = win
            Wn = W + RWf
            d = xm - m
            win[0] = m + d * (RWf / Wn)
            win[1] = r + raw_b + (W * RWf / Wn) * torch.outer(d, d)
            win[2] = Wn

    def swap_and_count(self, mult: float) -> None:
        """The shared window swap after the adds (``:267-290``)."""
        if self.ns - self.pu >= self.win:
            m, r, W = self.bg
            self.fg = [m, r, W]
            self.bg = [torch.zeros_like(m), torch.zeros_like(r), torch.zeros_like(W)]
            self.pu = self.ns
            self.win = math.floor(self.win * mult)
        self.ns += 1.0

    def results(self) -> Dict[str, torch.Tensor]:
        """The block's outputs under the op's names, counters apart."""
        out = dict(zip(_WELFORD_KEYS, self.fg + self.bg))
        out["counters"] = torch.tensor([self.ns, self.pu, self.win], dtype=torch.float32)
        return out


def stack_block_welford(blocks, device) -> Dict[str, torch.Tensor]:
    """The per-block Welford outputs of a plain version's blocks, stacked,
    with the shared counters (every block holds the same)."""
    res = {k: torch.stack([b[k] for b in blocks]) for k in _WELFORD_KEYS}
    res["n_samples"], res["prev_update"], res["window"] = blocks[0]["counters"].to(device)
    return res


def welford_buffers(dense_welford, B: int, empty) -> Dict[str, torch.Tensor]:
    """The fused kernels' Welford buffers: the seed (the global means, 1/B
    of the weights and the counters), per-block mean outputs, the raw
    scatters seeded with 1/B of the global ones (updated in place), and
    the per-block weights and counters."""
    fgm, fgr, fgw, bgm, bgr, bgw, ns, pu, win = dense_welford
    n = fgm.shape[0]
    return dict(
        welford_seed=torch.cat([fgm, bgm, torch.stack(
            [fgw / float(B), bgw / float(B), ns, pu, win])]).contiguous(),
        dense_fg_mean=empty(B, n), dense_bg_mean=empty(B, n),
        dense_fg_raw=(fgr / float(B)).expand(B, n, n).contiguous(),
        dense_bg_raw=(bgr / float(B)).expand(B, n, n).contiguous(),
        welford_out=empty(B, 8))


def welford_results(buf) -> Dict[str, torch.Tensor]:
    """The op's Welford outputs from :func:`welford_buffers` after a launch."""
    wo = buf["welford_out"]
    return dict(dense_fg_mean=buf["dense_fg_mean"], dense_fg_raw=buf["dense_fg_raw"],
                dense_fg_w=wo[:, 0], dense_bg_mean=buf["dense_bg_mean"],
                dense_bg_raw=buf["dense_bg_raw"], dense_bg_w=wo[:, 1],
                n_samples=wo[0, 2], prev_update=wo[0, 3], window=wo[0, 4])


def combine_dense_welford(W: torch.Tensor, m: torch.Tensor, r: torch.Tensor,
                          center: torch.Tensor):
    """Exactly combine stacked Welford states ``(B, ...)`` into one
    (``fused_nuts_pallas.py:380-396``): sum form centred at ``center``.
    Returns ``(W_tot, mean, raw)``."""
    W_tot = torch.sum(W)
    d = m - center  # (B, n)
    S1 = torch.sum(W[:, None] * d, dim=0)
    S2 = torch.sum(r + W[:, None, None] * (d[:, :, None] * d[:, None, :]), dim=0)
    mean = center + S1 / torch.clamp(W_tot, min=1e-30)
    md = mean - center
    raw = S2 - W_tot * torch.outer(md, md)
    return W_tot, mean, raw


# --------------------------------------------------------------------------
# The plain version
# --------------------------------------------------------------------------

def _cat_chains(outs, keys) -> Dict[str, torch.Tensor]:
    return {k: torch.cat([o[k] for o in outs]) for k in keys}


def fused_nuts_plain(q, grad, logp, iter_count, da_log_step, da_log_bar, da_hbar,
                     da_count, da_mu, var, linv, seed, *, spec: TrajectorySpec, T: int,
                     tuning: bool, config, metric: str = "dense",
                     window_multiplier: float = 1.0,
                     chain_block: int = DEFAULT_CHAIN_BLOCK, collect_trace: bool = True,
                     welford: Optional[Sequence[torch.Tensor]] = None,
                     dense_welford: Optional[Sequence[torch.Tensor]] = None,
                     fac: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The plain PyTorch op, block by block, on any device."""
    C, n = q.shape
    cb = resolve_chain_block(C, chain_block)
    B = C // cb
    w0, w1 = _seed_words(seed)
    coeffs = INTEGRATOR_COEFFS[config.integrator]
    adapting = tuning and config.adapt_step_size
    D = int(config.max_treedepth)

    def model(x):
        return body_logp_grad(spec, x)

    state = dict(zip(_SCALARS, (logp, iter_count, da_log_step, da_log_bar, da_hbar,
                                da_count, da_mu)))
    outs = []
    for blk in range(B):
        rows = slice(blk * cb, (blk + 1) * cb)
        s = {k: v[rows] for k, v in state.items()}
        qb, gb = q[rows], grad[rows]
        wel = _BlockWelford(dense_welford, B) if dense_welford is not None else None
        vb = var if metric == "dense" else var[rows]
        dw = DiagWelford(welford).rows(rows) if welford is not None else None
        per_draw = {k: [] for k in STAT_KEYS + ("trace",)}
        for t in range(T):
            seed0 = (w0 + t * _DRAW_STRIDE) & _M32
            p0, vel = momentum_and_velocity(metric, seed0, w1, blk, cb, vb, linv, fac)
            lp0 = s["logp"]
            E0 = 0.5 * _rowdot(p0, vel(p0)) - lp0
            eps = torch.exp(s["da_log_step"] if adapting else s["da_log_bar"])
            if tuning:
                early = s["iter_count"] < float(config.early_window)
                mdc = torch.where(early, config.early_max_treedepth, config.max_treedepth)
            else:
                mdc = torch.full_like(s["iter_count"], config.max_treedepth)
            out = transition_block(model, vel, block_uniform(seed0, w1, blk, cb, q.device),
                                   coeffs, float(config.Emax), D, qb, p0, gb, lp0, E0, eps,
                                   mdc.to(torch.int32))
            mta = mean_tree_accept(out["log_size"], out["log_weighted_accept_sum"])
            if adapting:
                _da_update(s, mta, config)
            s["iter_count"] = s["iter_count"] + 1.0
            s["logp"] = out["logp"]
            qb, gb = out["q"], out["grad"]
            if dw is not None and tuning:
                vb = dw.update(qb, window_multiplier)
            if wel is not None:
                wel.add_batch(qb)
                wel.swap_and_count(window_multiplier)
            per_draw["trace"].append(qb)
            for k, v in (("energy", out["energy"]), ("model_logp", out["logp"]),
                         ("energy_error", out["energy"] - E0), ("mean_tree_accept", mta),
                         ("step_size", torch.exp(s["da_log_step"])),
                         ("step_size_bar", torch.exp(s["da_log_bar"])),
                         ("max_energy_change", out["max_energy_change"]),
                         ("depth", out["depth"]), ("n_leaves", out["n_leaves"]),
                         ("diverging", out["diverging"]), ("turning", out["turning"])):
                per_draw[k].append(v)
        res = {k: torch.stack(v) for k, v in per_draw.items()}
        res.update(q=qb, grad=gb, **s)
        if dw is not None:
            res.update(var=vb, **dw.leaves)
        if wel is not None:
            res.update(wel.results())
        outs.append(res)
    return gather_blocks(outs, q.device, collect_trace, welford is not None,
                         dense_welford is not None, STAT_KEYS)


def gather_blocks(outs, device, collect_trace: bool, adapt_metric: bool, adapt_dense: bool,
                  stat_keys) -> Dict[str, torch.Tensor]:
    """A fused plain version's result from its blocks' results: the
    per-draw streams joined along the chain axis, the per-chain state and
    diag Welford state along the chains, the per-block pooled states
    stacked."""
    result = {k: torch.cat([o[k] for o in outs], dim=1) for k in stat_keys + ("trace",)}
    result.update(_cat_chains(outs, ("q", "grad") + _SCALARS))
    if not collect_trace:
        result["trace"] = None
    if adapt_metric:
        result.update(_cat_chains(outs, ("var",) + WELFORD_KEYS))
    if adapt_dense:
        result.update(stack_block_welford(outs, device))
    return result


# --------------------------------------------------------------------------
# The CUDA kernel's wrapper
# --------------------------------------------------------------------------

def check_inputs(spec, q, grad, scalars, var, linv, metric, welford, dense_welford, tuning,
                 fac=None):
    """The fused ops' input contract: float32 tensors of the shapes
    :func:`fused_nuts` documents, on one device."""
    C, n = q.shape
    if n != spec.ndim:
        raise ValueError(f"q has {n} columns but the model has {spec.ndim}")
    if metric not in METRIC_IDS:
        raise ValueError(f"unknown metric {metric!r}; known: {sorted(METRIC_IDS)}")
    if (fac is not None) != (metric == "lowrank"):
        raise ValueError("the low-rank metric, and only it, takes the factor block fac")
    dev = q.device
    named = [("q", q, (C, n)), ("grad", grad, (C, n))]
    named += [(k, v, (C,)) for k, v in zip(_SCALARS, scalars)]
    if metric == "dense":
        if welford is not None or linv is None:
            raise ValueError("the dense metric takes linv and no per-chain welford state")
        named += [("cov", var, (n, n)), ("linv", linv, (n, n))]
    else:
        if dense_welford is not None:
            raise ValueError("dense_welford (pooled dense adaptation) needs metric='dense'")
        named.append(("var", var, (C, n)))
        if metric == "lowrank":
            named.append(("fac", fac, (lowrank_fac_size(n),)))
        if welford is not None:
            named += [(k, v, (C, n) if k in _WELFORD_ROWS else (C,))
                      for k, v in zip(WELFORD_KEYS, welford)]
    if dense_welford is not None:
        if not tuning:
            raise ValueError("dense_welford (pooled dense adaptation) needs tuning=True")
        named += [(k, v, shape) for k, v, shape in zip(
            ("fg_mean", "fg_raw", "fg_w", "bg_mean", "bg_raw", "bg_w", "n_samples",
             "prev_update", "window"), dense_welford,
            ((n,), (n, n), (), (n,), (n, n), (), (), (), ()))]
    for name, t, shape in named:
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected torch.float32 {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    for c in spec.consts:
        if c.device != dev or c.dtype != torch.float32 or not c.is_contiguous():
            raise ValueError("model constants must be contiguous float32 on "
                             f"{dev}; got {c.dtype} on {c.device}")


def check_kernel_shapes(C: int, n: int, chain_block: int, metric: str = "diag") -> int:
    """The fused kernels' chain block for ``C`` chains, after checking what
    they take: at most 16 chains a block (the fused NUTS kernel's low-rank
    metric 8, :func:`.nuts_trajectory.kernel_chain_block`), ``n`` at most
    256."""
    cb = kernel_chain_block(C, chain_block, metric)
    if n > MAX_KERNEL_NDIM_DENSE:
        raise ValueError(f"the fused kernel takes n <= {MAX_KERNEL_NDIM_DENSE}, got {n}")
    return cb


def state_buffers(scalars, var, linv, metric, welford, empty,
                  fac=None) -> Dict[str, torch.Tensor]:
    """The fused kernels' state inputs and the outputs they update: the
    ``(C, 16)`` scalar state (the chain and dual averaging in columns 0-6,
    the diag Welford weights and counters in 8-13), the metric (``cov`` and
    ``linv``, or ``var``: the variances, stacked over the four Welford
    rows with ``welford``, and for the low-rank metric the factor block in
    ``cov``'s place) and the outputs."""
    C = scalars[0].shape[0]
    zero = torch.zeros_like(scalars[0])
    wl = dict(zip(WELFORD_KEYS, welford)) if welford is not None else {}
    cols = list(scalars) + [zero] + [wl.get(k, zero) for k in _WELFORD_COLS] + [zero] * 2
    buf = {"scal": torch.stack(cols, 1).contiguous(), "scal_out": empty(C, _N_SCAL),
           "cov": None, "linv": None, "var": None, "var_out": None}
    if metric == "dense":
        buf.update(cov=var.contiguous(), linv=linv.contiguous())
        return buf
    if metric == "lowrank":
        buf["cov"] = fac.contiguous()
    if welford is None:
        buf["var"] = var.contiguous()
    else:
        buf["var"] = torch.stack([var] + [wl[k] for k in _WELFORD_ROWS]).contiguous()
        buf["var_out"] = empty(5, *var.shape)
    return buf


def state_results(buf) -> Dict[str, torch.Tensor]:
    """The per-chain state leaves from :func:`state_buffers` after a launch."""
    so = buf["scal_out"]
    res = {k: so[:, i] for i, k in enumerate(_SCALARS)}
    if buf["var_out"] is not None:
        vo = buf["var_out"]
        res["var"] = vo[0]
        res.update({k: vo[1 + i] for i, k in enumerate(_WELFORD_ROWS)})
        res.update({k: so[:, 8 + i] for i, k in enumerate(_WELFORD_COLS)})
    return res


def _launch_kernel(q, grad, scalars, var, linv, seed, *, spec, T, tuning, config, metric,
                   window_multiplier, chain_block, collect_trace, welford, dense_welford, fac):
    from ._build import launch

    C, n = q.shape
    cb = check_kernel_shapes(C, n, chain_block, metric)
    B = C // cb
    D = int(config.max_treedepth)
    dev = q.device
    f32 = torch.float32
    w0, w1 = _seed_words(seed)
    b_coef, a_coef = INTEGRATOR_COEFFS[config.integrator]

    def empty(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)

    buf = {
        "q": q.contiguous(), "grad": grad.contiguous(),
        "consts": spec.kernel_consts,
        "stack": empty(*stack_shape(spec.body, metric, cb, D, C, n)), "q_out": empty(C, n),
        "grad_out": empty(C, n),
        "trace": empty(T, C, n) if collect_trace else None,
        "stat_f": empty(len(_STAT_F32), T, C), "stat_i": empty(2, T, C, dtype=torch.int32),
        "stat_b": empty(2, T, C, dtype=torch.bool),
    }
    buf.update(state_buffers(scalars, var, linv, metric, welford, empty, fac))
    adapt_dense = dense_welford is not None
    if adapt_dense:
        buf.update(welford_buffers(dense_welford, B, empty))
    ints = dict(C=C, n=n, D=D, T=int(T), cb=cb, n_stages=len(a_coef),
                body=BODY_IDS[spec.body], metric=METRIC_IDS[metric], tuning=int(bool(tuning)),
                adapting=int(bool(tuning) and config.adapt_step_size),
                adapt_metric=int(welford is not None), adapt_dense=int(adapt_dense),
                early_window=int(config.early_window),
                early_max=int(config.early_max_treedepth),
                max_depth=int(config.max_treedepth),
                seed0=int32_bits(w0), seed1=int32_bits(w1), Npad=padded_dim(n),
                rows=spec.rows)
    floats = dict(Emax=float(config.Emax), target_accept=float(config.target_accept),
                  gamma=float(config.gamma), k=float(config.k), t0=float(config.t0),
                  window_multiplier=float(window_multiplier))
    floats.update({f"b{i}": (list(b_coef) + [0.0] * 4)[i] for i in range(4)})
    floats.update({f"a{i}": (list(a_coef) + [0.0] * 3)[i] for i in range(3)})
    launch("fused_nuts", [buf[k].data_ptr() if buf.get(k) is not None else None for k in _PTRS],
           [ints[k] for k in _INTS], [floats[k] for k in _FLOATS], dev,
           lib=kernel_library("fused_nuts", spec, dev, C))
    fused_nuts.launches += 1

    res = {"trace": buf["trace"], "q": buf["q_out"], "grad": buf["grad_out"]}
    res.update(state_results(buf))
    res.update({k: buf["stat_f"][i] for i, k in enumerate(_STAT_F32)})
    res.update(depth=buf["stat_i"][0], n_leaves=buf["stat_i"][1],
               diverging=buf["stat_b"][0], turning=buf["stat_b"][1])
    if adapt_dense:
        res.update(welford_results(buf))
    return res


def fused_nuts(q, grad, logp, iter_count, da_log_step, da_log_bar, da_hbar, da_count,
               da_mu, var, linv, seed, *, spec: TrajectorySpec, T: int, tuning: bool,
               config, metric: str = "dense", window_multiplier: float = 1.0,
               chain_block: int = DEFAULT_CHAIN_BLOCK, collect_trace: bool = True,
               welford: Optional[Sequence[torch.Tensor]] = None,
               dense_welford: Optional[Sequence[torch.Tensor]] = None,
               fac: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """``T`` NUTS transitions for every chain, where the tensors lie.

    Inputs (float32): ``q, grad`` ``(C, n)``; the per-chain ``logp``,
    ``iter_count`` and dual-averaging leaves ``(C,)``; the metric ``var``:
    for ``metric="dense"`` the shared covariance ``(n, n)`` with its
    inverse lower Cholesky factor ``linv``, for ``metric="diag"`` the
    per-chain inverse-mass diagonals ``(C, n)`` and ``linv=None``, for
    ``metric="lowrank"`` the per-chain variances ``(C, n)``, ``linv=None``
    and ``fac`` the shared factor block of
    :func:`.nuts_trajectory.build_lowrank_fac`; ``seed`` two int32 words. ``config`` is a
    :class:`~littlemcmc_torch.base.NUTSConfig`. ``welford`` (diag: the
    per-chain adaptation, ``adapt_metric``) is the state of
    :data:`WELFORD_KEYS`, rows ``(C, n)`` and weights and counters
    ``(C,)``; tune chunks update it and ``var`` every draw, draw chunks
    pass it through (diag and low-rank alike; the factor stays frozen). ``dense_welford`` (dense: tune chunks of pooled
    adaptation) is the global pooled state ``(fg_mean (n,), fg_raw (n, n),
    fg_w, bg_mean, bg_raw, bg_w, n_samples, prev_update, window)``, scalars
    as 0-d tensors.

    Returns the JAX op's dict: ``trace`` ``(T, C, n)`` (None without
    ``collect_trace``), the per-draw stats of :data:`STAT_KEYS` ``(T, C)``,
    the final state leaves, with ``welford`` the updated ``var`` and
    Welford leaves, and with ``dense_welford`` the per-block states
    ``dense_fg_mean (B, n)``, ``dense_fg_raw (B, n, n)``, ``dense_fg_w
    (B,)`` (and ``dense_bg_*``) and the shared counters ``n_samples``,
    ``prev_update``, ``window``, for :func:`combine_dense_welford`.

    CPU tensors run :func:`fused_nuts_plain`; CUDA tensors launch the
    kernel (``fused_nuts.launches`` counts those launches) or raise.
    """
    scalars = (logp, iter_count, da_log_step, da_log_bar, da_hbar, da_count, da_mu)
    check_inputs(spec, q, grad, scalars, var, linv, metric, welford, dense_welford, tuning,
                 fac)
    kw = dict(spec=spec, T=T, tuning=tuning, config=config, metric=metric,
              window_multiplier=window_multiplier, chain_block=chain_block,
              collect_trace=collect_trace, welford=welford, dense_welford=dense_welford,
              fac=fac)
    if q.device.type == "cpu":
        return fused_nuts_plain(q, grad, *scalars, var, linv, seed, **kw)
    if q.device.type == "cuda":
        return _launch_kernel(q, grad, scalars, var, linv, seed, **kw)
    raise RuntimeError(f"no fused NUTS implementation for device {q.device}")


fused_nuts.launches = 0
