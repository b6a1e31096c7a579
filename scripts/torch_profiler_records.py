#!/usr/bin/env python3
"""Count the device records ``torch.profiler`` keeps against the launches
made, on the card.

    python3 scripts/torch_profiler_records.py [--reps=50] [--long] [--trials=N] [--churn]

Each case launches one kernel ``reps`` times inside one profiled window
and counts the kernel's device records in ``key_averages()``:

- ``torch``: PyTorch's own elementwise kernel (``x.add_(1)``);
- ``static`` and ``shared``: a small spin kernel (about 20 us) in a
  library with a plain C interface, loaded with ``ctypes`` as the port
  loads its kernels, built with ``nvcc -cudart static`` (the port's
  build) and with ``-cudart shared``; each tenth of the launches runs
  another instance (``spin<0>`` ... ``spin<9>``), so the counts by tenth
  say which launches lost their records;
- ``probe``: the port's ``cos`` probe wrapper (``ops/fused_probe.py``).

Each case runs in four windows: ``plain`` (the window opens, the launches
follow at once, one synchronise, the window closes), ``lead`` (a
synchronise and 50 ms of sleep before the first launch), ``trail`` (50 ms
of sleep after the synchronise) and ``settled``, the profiler
:func:`littlemcmc_torch.utils.profiling.device_trace` sets up. Prints one
JSON line a case and window, and the card's name and power limit.
``--long`` runs 500 launches a window. ``--trials=N`` runs instead ``N``
windows of each kind over 50 launches of 50 distinct short kernels
(``tag<0>`` ... ``tag<49>``, about 2 us each), each after a call of a case
(``--cases=``: nothing, an allocation, a device guard, the ``cos`` probe,
the NUTS trajectory kernel at 1024 chains of a 3-d standard normal), and
prints, for each window that lost records, which launches lost them (the
tag after a case's launch names it), when each was made on the host, and
where the window and the kept records lie on the profiler's clock (ms
from the window's start). Its windows add ``warm`` (a window opened and
closed just before). ``--churn`` runs instead pairs of windows over 20
launches of the NUTS trajectory kernel (a 3-d standard normal at 1024
chains), one a plain ``torch.profiler`` window, one ``device_trace``'s:
ten pairs back to back, then a pair after every 300,000 launches of a
one-element add outside any window, up to 2.4 million, and prints each
window's records of the 20 launches. Writes the built libraries under
``build/profiler_records/`` and the traces under
``chiprun_out/profiler_records/``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

_SPIN = r"""
#include <cuda_runtime.h>
template <int K>
__global__ void spin(float* x, long long cycles) {
  long long t0 = clock64();
  while (clock64() - t0 < cycles) {}
  if (threadIdx.x == 0) x[blockIdx.x] += (float)K;
}
extern "C" int spin_launch(float* x, int k, long long cycles, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 0: spin<0><<<8, 32, 0, s>>>(x, cycles); break;
    case 1: spin<1><<<8, 32, 0, s>>>(x, cycles); break;
    case 2: spin<2><<<8, 32, 0, s>>>(x, cycles); break;
    case 3: spin<3><<<8, 32, 0, s>>>(x, cycles); break;
    case 4: spin<4><<<8, 32, 0, s>>>(x, cycles); break;
    case 5: spin<5><<<8, 32, 0, s>>>(x, cycles); break;
    case 6: spin<6><<<8, 32, 0, s>>>(x, cycles); break;
    case 7: spin<7><<<8, 32, 0, s>>>(x, cycles); break;
    case 8: spin<8><<<8, 32, 0, s>>>(x, cycles); break;
    default: spin<9><<<8, 32, 0, s>>>(x, cycles); break;
  }
  return (int)cudaGetLastError();
}
"""


def _build_spin(cudart: str) -> ctypes.CDLL:
    from littlemcmc_torch.ops._build import _nvcc

    out = ROOT / "build" / "profiler_records"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "spin.cu"
    src.write_text(_SPIN)
    lib = out / f"libspin_{cudart}.so"
    subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-cudart", cudart, "-o", str(lib), str(src)],
                   check=True)
    dll = ctypes.CDLL(str(lib))
    dll.spin_launch.restype = ctypes.c_int
    dll.spin_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                                ctypes.c_void_p]
    return dll


_TAG = (r"""
#include <cuda_runtime.h>
template <int K>
__global__ void tag(float* x, long long cycles) {
  long long t0 = clock64();
  while (clock64() - t0 < cycles) {}
  if (threadIdx.x == 0) x[blockIdx.x] += (float)K;
}
extern "C" int tag_launch(float* x, int k, long long cycles, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
""" + "".join(f"    case {k}: tag<{k}><<<1, 32, 0, s>>>(x, cycles); break;\n" for k in range(50))
    + """  }
  return (int)cudaGetLastError();
}
""")


def _trials(n: int, log_dir: Path) -> None:
    """Which of 50 launches lose their records, over ``n`` windows a kind."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    from littlemcmc_torch.ops._build import _nvcc
    from littlemcmc_torch.utils.profiling import device_trace

    out = ROOT / "build" / "profiler_records"
    out.mkdir(parents=True, exist_ok=True)
    (out / "tag.cu").write_text(_TAG)
    lib = out / "libtag.so"
    subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib), str(out / "tag.cu")], check=True)
    dll = ctypes.CDLL(str(lib))
    dll.tag_launch.restype = ctypes.c_int
    dll.tag_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                               ctypes.c_void_p]
    from littlemcmc_torch.ops.fused_probe import probe_inputs, probe_kernel

    dev = torch.device("cuda")
    x = torch.zeros(8, device=dev)
    st = torch.cuda.current_stream().cuda_stream
    cos_in = probe_inputs("cos", dev)

    def with_device():
        with torch.cuda.device(dev):
            pass

    from littlemcmc_torch.models import StandardNormal
    from littlemcmc_torch.ops.nuts_trajectory import trajectory

    sn = StandardNormal(3)
    C = 1024
    tq = torch.randn(C, 3, device=dev)
    targs = (tq, torch.randn(C, 3, device=dev), -tq, -0.5 * (tq * tq).sum(1),
             torch.full((C,), 0.5, device=dev), torch.full((C,), 6, dtype=torch.int32,
                                                           device=dev),
             torch.ones(C, 3, device=dev))
    tkw = dict(spec=sn.trajectory_spec(), max_treedepth=6, Emax=1000.0, chain_block=8)
    # what runs before each tagged launch
    befores = {"tag": None, "tag_empty": lambda: torch.empty(1024, device=dev),
               "tag_device": with_device,
               "probe_tagged": lambda: probe_kernel("cos", cos_in, dev),
               "traj_tagged": lambda: trajectory(*targs, (3, 8), **tkw)}
    chosen = [a.split("=", 1)[1].split(",") for a in sys.argv[1:] if a.startswith("--cases=")]
    if chosen:
        befores = {k: v for k, v in befores.items() if k in chosen[0]}
    kinds = ("plain", "lead", "trail", "settled", "warm")
    for k in range(50):
        dll.tag_launch(x.data_ptr(), k, 4000, st)
        probe_kernel("cos", cos_in, dev)
        trajectory(*targs, (3, 8), **tkw)
    torch.cuda.synchronize()
    name_of = {"probe_tagged": "probe_cos", "traj_tagged": "nuts_trajectory"}
    for case, before in befores.items():
        for kind in kinds:
            lost_total, lost_windows, probe_lost = 0, 0, 0
            for trial in range(n):
                host = []
                if kind == "warm":
                    # a window opened and closed before the measured one
                    with device_trace(str(log_dir / "trials"), check=False):
                        pass
                if kind in ("settled", "warm"):
                    cm = device_trace(str(log_dir / "trials"), check=False)
                else:
                    cm = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                with cm as p:
                    h0 = time.time_ns()
                    if kind == "lead":
                        torch.cuda.synchronize()
                        time.sleep(0.05)
                    for k in range(50):
                        host.append(time.time_ns())
                        if before is not None:
                            before()
                        dll.tag_launch(x.data_ptr(), k, 4000, st)
                    torch.cuda.synchronize()
                    if kind == "trail":
                        time.sleep(0.05)
                    h1 = time.time_ns()
                prof = p.profiler if kind in ("settled", "warm") else p
                try:
                    res = prof.profiler.kineto_results
                    res.trace_start_ns()
                except Exception as exc:  # noqa: BLE001 - a diagnostic: report, go on
                    print(json.dumps({"case": case, "window": kind,
                                      "unread": f"{type(exc).__name__}: {exc}"}), flush=True)
                    break
                t0 = res.trace_start_ns()
                kept, probes = {}, []
                for e in res.events():
                    if e.device_type() != torch.autograd.DeviceType.CUDA:
                        continue
                    m = re.search(r"tag<(\d+)>", e.name())
                    if m:
                        kept[int(m.group(1))] = (e.start_ns() - t0) / 1e6
                    elif name_of.get(case, "-") in e.name():
                        probes.append((e.start_ns() - t0) / 1e6)
                lost = [k for k in range(50) if k not in kept]
                # a probe record belongs to the first tag that starts after it
                tag_times = sorted(kept.items(), key=lambda kv: kv[1])
                got = {next((k for k, t in tag_times if t > pt), None) for pt in probes}
                p_lost = ([k for k in range(50) if k not in got] if case in name_of
                          else [])
                lost_total += len(lost)
                probe_lost += len(p_lost)
                if lost or p_lost:
                    lost_windows += 1
                    print(json.dumps({
                        "case": case, "window": kind, "trial": trial, "lost": lost,
                        "probe_lost": p_lost, "probe_records": len(probes),
                        "lost_host_ms": [round((host[k] - h0) / 1e6, 3) for k in lost + p_lost],
                        "host_open_ms": round((h0 - t0) / 1e6, 3),
                        "host_close_ms": round((h1 - t0) / 1e6, 3),
                        "first_launch_host_ms": round((host[0] - t0) / 1e6, 3),
                        "kept_first_last_ms": [round(min(kept.values()), 3),
                                               round(max(kept.values()), 3)] if kept else None,
                    }), flush=True)
            print(json.dumps({"case": case, "window": kind, "trials": n,
                              "windows_losing": lost_windows, "tag_records_lost": lost_total,
                              "probe_records_lost": probe_lost, "launches": 50 * n}),
                  flush=True)


def _churn() -> None:
    """Records of plain and ``device_trace`` windows as the launches made
    outside them grow."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from littlemcmc_torch.models import StandardNormal
    from littlemcmc_torch.ops.nuts_trajectory import trajectory
    from littlemcmc_torch.utils.profiling import device_trace

    dev = torch.device("cuda")
    C = 1024
    q = torch.randn(C, 3, device=dev)
    targs = (q, torch.randn(C, 3, device=dev), -q, -0.5 * (q * q).sum(1),
             torch.full((C,), 0.5, device=dev),
             torch.full((C,), 6, dtype=torch.int32, device=dev), torch.ones(C, 3, device=dev))
    kw = dict(spec=StandardNormal(3).trajectory_spec(), max_treedepth=6, Emax=1000.0,
              chain_block=8)
    trajectory(*targs, (3, 8), **kw)
    torch.cuda.synchronize()
    x = torch.zeros(1, device=dev)

    def pair(outside: int) -> None:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            for _ in range(20):
                trajectory(*targs, (3, 8), **kw)
            torch.cuda.synchronize()
        plain = sum(1 for e in p.events() if e.device_type == torch.autograd.DeviceType.CUDA
                    and "nuts_trajectory" in e.name)
        with tempfile.TemporaryDirectory() as d:
            with device_trace(d, check=False) as tr:
                for _ in range(20):
                    trajectory(*targs, (3, 8), **kw)
        print(json.dumps({"launches_outside_windows": outside, "plain_records_of_20": plain,
                          "device_trace_records_of_20": tr.kernel_records("nuts_trajectory")}),
              flush=True)

    for _ in range(10):
        pair(0)
    for k in range(1, 9):
        for _ in range(300_000):
            x.add_(1.0)
        torch.cuda.synchronize()
        pair(300_000 * k)


def _window(kind: str, launch, reps: int, name: str, log_dir: Path) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from littlemcmc_torch.utils.profiling import device_records, device_trace

    launch(0)
    torch.cuda.synchronize()
    if kind == "settled":
        with device_trace(str(log_dir / name), check=False) as tr:
            for i in range(reps):
                launch(i * 10 // reps)
        recs = device_records(tr.profiler)
    else:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if kind == "lead":
                torch.cuda.synchronize()
                time.sleep(0.05)
            for i in range(reps):
                launch(i * 10 // reps)
            torch.cuda.synchronize()
            if kind == "trail":
                time.sleep(0.05)
        recs = device_records(prof)
    prof = tr.profiler if kind == "settled" else prof
    try:
        raw = sum(1 for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA and name in e.name())
    except Exception as exc:  # noqa: BLE001 - a diagnostic: report, go on
        raw = f"unread: {type(exc).__name__}"
    hits = {k: n for k, n in recs.items() if name in k}
    by_tenth = [sum(n for k, n in hits.items() if f"<{t}>" in k) for t in range(10)]
    return {"records": sum(hits.values()), "raw_records": raw, "launches": reps,
            "by_tenth": by_tenth if name == "spin" else None,
            "other_device_records": sum(recs.values()) - sum(hits.values())}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    reps = 50
    for a in sys.argv[1:]:
        if a.startswith("--reps="):
            reps = int(a.split("=", 1)[1])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip(), flush=True)
    from littlemcmc_torch.ops.fused_probe import probe_inputs, probe_kernel

    dev = torch.device("cuda")
    x = torch.zeros(8, device=dev)
    cycles = 40_000  # about 20 us at 1.98 GHz
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    libs = {c: _build_spin(c) for c in ("static", "shared")}
    cos_in = probe_inputs("cos", dev)
    cases = {
        "torch": (lambda k: x.add_(1.0), "add"),
        "static": (lambda k: libs["static"].spin_launch(x.data_ptr(), k, cycles, stream()),
                   "spin"),
        "shared": (lambda k: libs["shared"].spin_launch(x.data_ptr(), k, cycles, stream()),
                   "spin"),
        "probe": (lambda k: probe_kernel("cos", cos_in, dev), "probe_cos"),
    }
    if "--long" in sys.argv:
        reps = 500
    log_dir = ROOT / "chiprun_out" / "profiler_records"
    if "--churn" in sys.argv:
        _churn()
        return
    for a in sys.argv[1:]:
        if a.startswith("--trials="):
            _trials(int(a.split("=", 1)[1]), log_dir)
            return
    for case, (launch, name) in cases.items():
        for kind in ("plain", "lead", "trail", "settled"):
            res = _window(kind, launch, reps, name, log_dir)
            print(json.dumps({"case": case, "window": kind, **res}), flush=True)
    _sample_case(log_dir)


def _sample_case(log_dir: Path) -> None:
    """The NUTS main path (the 100-d correlated Gaussian, 1024 chains, 20 +
    20) in a plain profile and in ``device_trace``: records of the
    trajectory kernel against its launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from littlemcmc_torch import sample
    from littlemcmc_torch.models import CorrelatedGaussian
    from littlemcmc_torch.utils.profiling import device_records, device_trace

    m = CorrelatedGaussian(100)
    kw = dict(model_ndim=100, chains=1024, tune=20, draws=20, random_seed=42,
              progressbar=False, compute_convergence_checks=False)
    sample(m.logp_grad, **kw)
    for kind in ("plain", "settled"):
        rep = {}
        if kind == "plain":
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                sample(m.logp_grad, perf_report=rep, **kw)
                torch.cuda.synchronize()
        else:
            with device_trace(str(log_dir / "sample"), check=False) as tr:
                sample(m.logp_grad, perf_report=rep, **kw)
            prof = tr.profiler
        recs = device_records(prof)
        print(json.dumps({"case": "sample", "window": kind,
                          "records": sum(n for k, n in recs.items() if "nuts_trajectory" in k),
                          "launches": rep["kernel_launches"]["nuts_trajectory"],
                          "device_records": sum(recs.values())}), flush=True)


if __name__ == "__main__":
    main()
