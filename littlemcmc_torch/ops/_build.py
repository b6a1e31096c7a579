"""Build the CUDA kernels with ``nvcc`` at first use and load them.

Every ``csrc/*.cu`` source compiles, all at once with one ``nvcc``
process each, into its own shared library with a plain C interface
under ``build/littlemcmc_torch/<hash>/`` at the root of the checkout; the
hash covers the sources and the flags, so an edited source rebuilds. The
libraries are loaded with ``ctypes``. A missing ``nvcc`` or a failed
build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional, Sequence

__all__ = ["build_all", "load_library", "launch", "BUILD_FLAGS"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "littlemcmc_torch"

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
    return sorted(_CSRC.glob("*.cu"))


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(BUILD_FLAGS).encode())
    for src in _sources() + sorted(_CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16]


@functools.lru_cache(maxsize=1)
def build_all() -> Dict[str, Path]:
    """Compile every source not yet built (in parallel); return name -> .so.

    Each library is written to a temporary name and renamed into place,
    so processes that build at the same time do not see half a file.
    """
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: out_dir / f"lib{src.stem}.so" for src in _sources()}
    procs = []
    for src in _sources():
        target = libs[src.stem]
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [_nvcc(), *BUILD_FLAGS, "-o", tmp, str(src)]
        procs.append((src, target, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for src, target, tmp, cmd, proc in procs:
        log, _ = proc.communicate()
        (out_dir / f"{src.stem}.log").write_text(" ".join(cmd) + "\n" + log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{src.name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, target)
    if failures:
        raise RuntimeError("nvcc failed to build:\n" + "\n".join(failures))
    return libs


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
}


@functools.lru_cache(maxsize=None)
def load_library(name: str = "nuts_trajectory") -> ctypes.CDLL:
    """The built library ``name`` with its functions' types declared."""
    lib = ctypes.CDLL(str(build_all()[name]))
    for fn, (restype, argtypes) in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    return lib


def launch(name: str, ptrs: Sequence[Optional[int]], ints: Sequence[int],
           floats: Sequence[float], device) -> None:
    """Call ``{name}_launch(ptrs, ints, floats, stream)`` of the library
    ``name`` on ``device``'s current stream: device pointers (None for
    null), C ints and C floats, in the orders the kernel's source declares.
    Raises on a CUDA error."""
    import torch

    lib = load_library(name)
    args = [(ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(ints))(*ints),
            (ctypes.c_float * len(floats))(*floats)]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"{name}_launch")(*(ctypes.cast(a, _P) for a in args), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({lib.cuda_error_string(err).decode()})")
