"""Capability self-checks of the fused kernels, run where the engine is elected.

Counterpart of ``littlemcmc_tpu/ops/fused_probe.py``: the six Mosaic
capability probes (``pallas_call`` at ``:77``, ``:112``, ``:165``, ``:226``,
``:302``, ``:381``), which the JAX package runs before it elects the fused
engine on a TPU (``fused_engine_supported``, ``sampling.py:1278-1290``) and
before the low-rank kernels (``lowrank_kernel_supported``, ``:1088-1095``).
Each probe here is a small CUDA kernel (``csrc/fused_probe.cu``) that runs
the JAX probe's computation on the JAX probe's inputs with the construct
the port's fused kernels use in place of the Mosaic one (cosf/sinf, state
in shared memory across the steps of one launch, a shared scalar and an
(N, N) accumulator in dynamic shared memory, the low-rank warp-sum
matvecs, the trace and stats layout, per-block outputs). Two
implementations each:

- :func:`probe_plain`, plain PyTorch, the yardstick;
- :func:`probe_kernel`, the CUDA kernel for tensors on a CUDA device (on
  CPU tensors it runs the plain version).

:func:`check_probe` runs one kernel on the card and holds it against the
plain version at the JAX probe's tolerance. ``sample()`` runs
:func:`fused_engine_check` (cos, grid_scratch, stat_io_layout,
smem_accumulate, block_outputs_3d) where ``fuse_draws=None`` elects the
fused engine on the card, and :func:`lowrank_kernel_check` (thin_factor)
where a kernel runs the pooled low-rank metric, at every such call.

**Departure from the JAX package:** a probe that disagrees **raises**,
where the JAX probe returns False and ``sample()`` falls back to the
per-draw engine with a warning. A CUDA kernel that computes another
function is a fault of this port's build or of the card, and a fallback
would hide it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..math import fp32_matmul

__all__ = ["PROBES", "FUSED_ENGINE_PROBES", "check_probe", "fused_engine_check",
           "lowrank_kernel_check", "probe_inputs", "probe_kernel", "probe_plain"]

# name -> (T, B, R, N, K): the JAX probes' sizes
PROBES = {
    "cos": (1, 1, 8, 128, 0),
    "grid_scratch": (7, 1, 8, 128, 0),
    "smem_accumulate": (5, 1, 8, 128, 0),
    "thin_factor": (1, 1, 8, 128, 8),
    "stat_io_layout": (3, 2, 8, 128, 16),   # K: the stats block's width W
    "block_outputs_3d": (3, 2, 8, 128, 0),
}
# what fused_engine_supported runs, in its order
FUSED_ENGINE_PROBES = ("cos", "grid_scratch", "stat_io_layout", "smem_accumulate",
                       "block_outputs_3d")
# name -> (inputs, outputs), in the launch's pointer order
_ARGS = {
    "cos": (("x",), ("o",)),
    "grid_scratch": ((), ("o",)),
    "smem_accumulate": (("x",), ("o", "cnt")),
    "thin_factor": (("x", "fac"), ("o",)),
    "stat_io_layout": (("seed", "q0", "sin", "const"), ("tr", "st", "qf", "sout")),
    "block_outputs_3d": ((), ("mf", "sqf", "cf")),
}
# name -> (rtol, atol) of the JAX probe's np.allclose
_TOL = {"cos": (1e-5, 1e-5), "grid_scratch": (1e-5, 1e-8), "smem_accumulate": (1e-5, 1e-4),
        "thin_factor": (1e-5, 1e-5), "stat_io_layout": (1e-5, 1e-5),
        "block_outputs_3d": (0.0, 0.0)}
# launch arguments, in the order of csrc/fused_probe.cu's enum
_INTS = ("probe", "T", "B", "R", "N", "K")


def probe_inputs(name: str, device) -> Dict[str, torch.Tensor]:
    """The JAX probe's inputs (``fused_probe.py``), made with numpy, on
    ``device``."""
    T, B, R, N, K = PROBES[name]
    if name in ("cos", "smem_accumulate"):
        lo = -6 if name == "cos" else -1
        x = {"x": np.linspace(lo, -lo, R * N, dtype=np.float32).reshape(R, N)}
    elif name == "thin_factor":
        rng = np.random.RandomState(0)
        x = rng.standard_normal((R, N)).astype(np.float32)
        V = np.linalg.qr(rng.standard_normal((N, K)))[0].astype(np.float32)
        fac = np.zeros((16, N), np.float32)
        fac[:K] = V.T
        fac[K, :K] = np.linspace(9.0, 0.25, K).astype(np.float32)
        fac[K + 1, :] = np.float32(0.37)
        x = {"x": x, "fac": fac}
    elif name == "stat_io_layout":
        rng = np.random.RandomState(1)
        x = {"seed": np.array([3, 0], np.int32),
             "q0": rng.standard_normal((B * R, N)).astype(np.float32),
             "sin": rng.standard_normal((B * R, K)).astype(np.float32),
             "const": rng.standard_normal((R, N)).astype(np.float32)}
    else:
        x = {}
    return {k: torch.from_numpy(v).to(device) for k, v in x.items()}


def probe_plain(name: str, inputs: Dict[str, torch.Tensor], device="cpu"
                ) -> Dict[str, torch.Tensor]:
    """The probe's outputs in plain PyTorch, on its inputs' device (else on
    ``device``); ``stat_io_layout``'s ``st``: its three written columns."""
    T, B, R, N, K = PROBES[name]
    dev = next(iter(inputs.values())).device if inputs else torch.device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    if name == "cos":
        return {"o": torch.cos(inputs["x"]) + torch.sin(inputs["x"])}
    if name == "grid_scratch":
        acc = torch.ones(R, N, **f32)
        for _ in range(T - 1):
            acc = acc * 2.0 + 1.0
        return {"o": acc}
    if name == "smem_accumulate":
        x = inputs["x"]
        acc = torch.zeros(N, N, **f32)
        for w in range(1, T + 1):
            acc = acc + fp32_matmul((x * w).T, x * w)
        return {"o": acc, "cnt": torch.full((1,), float(T + 1), **f32)}
    if name == "thin_factor":
        x, fac = inputs["x"], inputs["fac"]
        Vt, lam, alpha = fac[:K], fac[K, :K], fac[K + 1]
        return {"o": alpha * x + fp32_matmul(fp32_matmul(x, Vt.T) * (lam - alpha[:K]), Vt)}
    if name == "stat_io_layout":
        q = inputs["q0"].reshape(B, R, N).clone()
        sa = inputs["sin"].reshape(B, R, K).clone()
        seed = float(inputs["seed"][0])
        tr, st = [], []
        for t in range(T):
            q = q + inputs["const"] + seed
            tr.append(q.reshape(B * R, N))
            st.append((sa[..., :3] + torch.tensor([0.0, 10.0, 20.0], **f32) + float(t))
                      .reshape(B * R, 3))
            sa[..., 0] += 1.0
        return {"tr": torch.stack(tr), "st": torch.cat(st), "qf": q.reshape(B * R, N),
                "sout": sa.reshape(B * R, K)}
    if name == "block_outputs_3d":
        v = (torch.arange(1, B + 1, **f32) * T)[:, None, None]
        return {"mf": v.expand(B, 8, N).clone(), "sqf": v.expand(B, N, N).clone(),
                "cf": (2 * v).expand(B, 8, N).clone()}
    raise KeyError(name)


def _out_shapes(name: str) -> Dict[str, tuple]:
    T, B, R, N, K = PROBES[name]
    return {"cos": {"o": (R, N)}, "grid_scratch": {"o": (R, N)},
            "smem_accumulate": {"o": (N, N), "cnt": (1,)}, "thin_factor": {"o": (R, N)},
            "stat_io_layout": {"tr": (T, B * R, N), "st": (T * B * R, K), "qf": (B * R, N),
                               "sout": (B * R, K)},
            "block_outputs_3d": {"mf": (B, 8, N), "sqf": (B, N, N), "cf": (B, 8, N)}}[name]


def probe_kernel(name: str, inputs: Dict[str, torch.Tensor], device=None
                 ) -> Dict[str, torch.Tensor]:
    """The probe's outputs where its inputs lie (``device`` for the probes
    without inputs): CPU tensors run :func:`probe_plain`, CUDA tensors
    launch the kernel (``probe_kernel.launches[name]`` counts those
    launches) or raise. ``stat_io_layout``'s ``st`` is cut to its three
    written columns."""
    dev = torch.device(device) if device is not None else next(iter(inputs.values())).device
    if dev.type == "cpu":
        return probe_plain(name, inputs, dev)
    if dev.type != "cuda":
        raise RuntimeError(f"no fused probe implementation for device {dev}")
    from ._build import launch

    T, B, R, N, K = PROBES[name]
    ins, outs = _ARGS[name]
    bufs = [inputs[k].contiguous() for k in ins]
    out = {k: torch.empty(s, dtype=torch.float32, device=dev)
           for k, s in _out_shapes(name).items()}
    ptrs = [b.data_ptr() for b in bufs] + [out[k].data_ptr() for k in outs]
    ints = {"probe": list(PROBES).index(name), "T": T, "B": B, "R": R, "N": N, "K": K}
    launch("fused_probe", ptrs + [None] * (8 - len(ptrs)), [ints[k] for k in _INTS], [], dev)
    probe_kernel.launches[name] += 1
    if name == "stat_io_layout":
        out["st"] = out["st"][:, :3]
    return out


probe_kernel.launches = dict.fromkeys(PROBES, 0)


def check_probe(name: str, device=None) -> float:
    """Run probe ``name`` on the card and hold it against its plain version
    at the JAX probe's tolerance; return the largest absolute error, or
    raise ``RuntimeError`` (also on the CPU, where nothing would run)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise RuntimeError(f"the fused probe {name} runs on the CUDA card; {dev} is not one")
    inputs = probe_inputs(name, dev)
    got = probe_kernel(name, inputs, dev)
    want = probe_plain(name, inputs, dev)
    rtol, atol = _TOL[name]
    err = 0.0
    for k, w in want.items():
        g = got[k]
        err = max(err, float((g - w).abs().max()))
        if not torch.allclose(g, w, rtol=rtol, atol=atol):
            raise RuntimeError(
                f"the fused-kernel capability probe {name} disagrees with its plain version "
                f"({k}: max abs error {err:.3g}, rtol {rtol}, atol {atol}): a fault of the "
                f"CUDA build or of the card; the fused kernels are not run on it")
    return err


def fused_engine_check(device=None) -> Dict[str, float]:
    """The probes of ``fused_engine_supported`` on the card: name -> max abs
    error, or raise."""
    return {name: check_probe(name, device) for name in FUSED_ENGINE_PROBES}


def lowrank_kernel_check(device=None) -> Dict[str, float]:
    """The probe of ``lowrank_kernel_supported`` on the card, or raise."""
    return {"thin_factor": check_probe("thin_factor", device)}
