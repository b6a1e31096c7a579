"""Build the CUDA kernels with ``nvcc`` at first use and load them.

Every ``csrc/*.cu`` source compiles, all at once with one ``nvcc``
process each, into its own shared library with a plain C interface
under ``build/littlemcmc_torch/<hash>/`` at the root of the checkout; the
hash covers the sources and the flags, so an edited source rebuilds. The
libraries are loaded with ``ctypes``. A missing ``nvcc`` or a failed
build raises: there is no fallback.

A body generated from a user model (:mod:`.autospec`) builds apart
(:func:`build_generated`): its header and a translation unit that
includes one kernel's source with the body switched on
(``LMC_AUTOSPEC_HEADER``, ``LMC_AUTOSPEC_ONLY``; the probe kernel
``csrc/autospec_probe.cu`` takes ``LMC_AUTOSPEC_PROBE_HEADER``) go to
``build/littlemcmc_torch/autospec/<hash>/``, the hash over the generated
header, the kernel's name, the flags and every source and header.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

__all__ = ["build_all", "build_generated", "load_library", "load_generated", "launch",
           "BUILD_FLAGS"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "littlemcmc_torch"
# sources that compile only with a generated header
_GENERATED_ONLY = ("autospec_probe",)

BUILD_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` (default ``/usr/local/cuda``)."""
    found = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(found):
        return found
    raise RuntimeError("nvcc not found: the CUDA kernels of littlemcmc_torch "
                       "are built from source at first use and need the CUDA "
                       "toolkit on PATH")


def _sources():
    return sorted(p for p in _CSRC.glob("*.cu") if p.stem not in _GENERATED_ONLY)


def _sources_hash(generated: bool = False):
    """The flags and the static sources with every header; ``generated``
    adds the sources that build only with a generated header."""
    h = hashlib.sha256(" ".join(BUILD_FLAGS).encode())
    files = _sources() + sorted(_CSRC.glob("*.cuh"))
    if generated:
        files += [_CSRC / f"{stem}.cu" for stem in _GENERATED_ONLY]
    for src in files:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h


def _compile(jobs) -> None:
    """Run ``nvcc`` on every ``(source, target, log)`` whose target is
    missing, all at once. Each library is written to a temporary name and
    renamed into place, so processes that build at the same time do not
    see half a file. Raises on any failure."""
    procs = []
    for src, target, log_path in jobs:
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
        os.close(fd)
        cmd = [_nvcc(), *BUILD_FLAGS, "-o", tmp, str(src)]
        procs.append((src, target, log_path, tmp, cmd, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for src, target, log_path, tmp, cmd, t0, proc in procs:
        log, _ = proc.communicate()
        # the seconds are an upper bound: the processes run together and are
        # waited for in turn
        log_path.write_text(" ".join(cmd) + "\n" + log
                            + f"nvcc_seconds {time.perf_counter() - t0:.1f}\n")
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{src.name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, target)
    if failures:
        raise RuntimeError("nvcc failed to build:\n" + "\n".join(failures))


def _generated_job(kernel: str, header: str):
    """The files of ``kernel``'s build with a generated header, written
    if missing: ``(translation unit, library, log)``."""
    h = _sources_hash(generated=True)
    h.update(kernel.encode())
    h.update(header.encode())
    out_dir = _BUILD_ROOT / "autospec" / h.hexdigest()[:16]
    out_dir.mkdir(parents=True, exist_ok=True)
    probe = kernel in _GENERATED_ONLY
    head = out_dir / ("autospec_probe_bodies.cuh" if probe else "autospec_body.cuh")
    tu = out_dir / f"{kernel}_generated.cu"
    if not tu.exists():
        head.write_text(header)
        defines = (f'#define LMC_AUTOSPEC_PROBE_HEADER "{head}"\n' if probe else
                   f'#define LMC_AUTOSPEC_HEADER "{head}"\n#define LMC_AUTOSPEC_ONLY\n')
        tu.write_text(f"// {kernel}.cu with a generated model body\n{defines}"
                      f'#include "{_CSRC / (kernel + ".cu")}"\n')
    return tu, out_dir / f"lib{kernel}.so", out_dir / f"{kernel}.log"


def build_generated(jobs: Sequence) -> list:
    """Build each ``(kernel, generated header)`` not yet built, all at
    once; return their libraries' paths."""
    files = [_generated_job(k, h) for k, h in jobs]
    _compile(files)
    return [f[1] for f in files]


def _static_jobs() -> Dict[str, tuple]:
    """name -> ``(source, library, log)`` of every source's own build."""
    out_dir = _BUILD_ROOT / _sources_hash().hexdigest()[:16]
    out_dir.mkdir(parents=True, exist_ok=True)
    return {src.stem: (src, out_dir / f"lib{src.stem}.so", out_dir / f"{src.stem}.log")
            for src in _sources()}


@functools.lru_cache(maxsize=1)
def _build_static() -> Dict[str, Path]:
    jobs = _static_jobs()
    _compile(jobs.values())
    return {name: job[1] for name, job in jobs.items()}


def build_all() -> Dict[str, Path]:
    """Compile every source not yet built, in parallel; return name -> .so."""
    return _build_static()


_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float

# argument types of every exported C function, by library
_SIGNATURES = {
    "nuts_trajectory": {
        "nuts_trajectory_launch": (
            _I, [_P, _P, _P, _P, _P,          # q p g var fac
                 _P, _P, _P,                  # logp eps mdc
                 _U, _U, _I, _I, _P, _I,      # seed0 seed1 body metric consts rows
                 _I, _I, _I, _F, _I, _I, _P,  # C n D Emax cb n_stages coef
                 _P,                          # stack
                 _P, _P, _P, _P, _P, _P, _P,  # q g energy logp ls lwas mec
                 _P, _P, _P, _P,              # depth n_leaves div turn
                 _P]),                        # stream
        "cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    # pointers, ints, floats (each module's _PTRS, _INTS, _FLOATS), stream
    "fused_nuts": {
        "fused_nuts_launch": (_I, [_P, _P, _P, _P]),
        "cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "hmc_trajectory": {
        "hmc_trajectory_launch": (_I, [_P, _P, _P, _P]),
        "cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "fused_hmc": {
        "fused_hmc_launch": (_I, [_P, _P, _P, _P]),
        "cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "logistic_logp_grad": {
        "logistic_logp_grad_launch": (_I, [_P, _P, _P, _P]),
        "cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "quadform_logp_grad": {
        "quadform_logp_grad_launch": (_I, [_P, _P, _P, _P]),
        "cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "fused_probe": {
        "fused_probe_launch": (_I, [_P, _P, _P, _P]),
        "cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "autospec_probe": {
        "autospec_probe_launch": (_I, [_P, _P, _P, _P]),
        "cuda_error_string": (ctypes.c_char_p, [_I]),
    },
}
# what a generated body's library exports besides its kernel's functions
_GENERATED_SIGNATURES = {"autospec_bind_scratch": (_I, [_P, _P])}


def _declare(lib: ctypes.CDLL, signatures) -> ctypes.CDLL:
    for fn, (restype, argtypes) in signatures.items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    return lib


@functools.lru_cache(maxsize=None)
def load_library(name: str = "nuts_trajectory") -> ctypes.CDLL:
    """The built library ``name`` with its functions' types declared."""
    return _declare(ctypes.CDLL(str(build_all()[name])), _SIGNATURES[name])


@functools.lru_cache(maxsize=None)
def _load_generated_path(name: str, path: str) -> ctypes.CDLL:
    sigs = dict(_SIGNATURES[name])
    if name not in _GENERATED_ONLY:
        sigs.update(_GENERATED_SIGNATURES)
    return _declare(ctypes.CDLL(path), sigs)


def load_generated(name: str, header: str):
    """``(library, path)`` of kernel ``name`` built with a generated
    header, built first if missing."""
    path = str(build_generated([(name, header)])[0])
    return _load_generated_path(name, path), path


def launch(name: str, ptrs: Sequence[Optional[int]], ints: Sequence[int],
           floats: Sequence[float], device, lib: Optional[ctypes.CDLL] = None) -> None:
    """Call ``{name}_launch(ptrs, ints, floats, stream)`` of the library
    ``name`` (or of ``lib``, a generated body's build of it) on
    ``device``'s current stream: device pointers (None for null), C ints
    and C floats, in the orders the kernel's source declares. Raises on a
    CUDA error."""
    import torch

    lib = lib or load_library(name)
    args = [(ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(ints))(*ints),
            (ctypes.c_float * len(floats))(*floats)]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"{name}_launch")(*(ctypes.cast(a, _P) for a in args), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({lib.cuda_error_string(err).decode()})")
