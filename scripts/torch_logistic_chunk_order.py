#!/usr/bin/env python3
"""The logistic body's order of work past one gradient chunk, on the card.

    python3 scripts/torch_logistic_chunk_order.py

Times the per-draw NUTS kernel with the logistic body (3) at n = 25, 40
and 256 (1000 rows, 1024 chains, phase 2k's kind of input from
``chip_smoke._posterior_inputs``; the n = 40 and 256 designs of
independent standard-normal features) with the sources as they are (each
row block's logits first, then the gradient chunks, one reduce-scatter a
block and chunk) and with a variant that reads each row twice per chunk
(the logit recomputed for every chunk, one reduce-scatter a chunk),
built from a copy of ``littlemcmc_torch/ops/csrc`` under ``build/``.
Runs in turns (sources, variant, variant, sources) and prints one JSON
line a run (ms a launch on CUDA events, leaves a chain, a checksum of q)
and ptxas's lines for both builds' ``nuts_trajectory<3, diag>``.
"""
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# the variant's logistic_rows: each chunk reads every row again for its logit
VARIANT_BODY = r'''__device__ __forceinline__ float logistic_rows(const float* q, const float* X, int ldx,
                                               const float* y, int rows, int n, int lane,
                                               float* g) {
    constexpr int R = kLogisticRows, W = kLogisticChunk;
    const int chunks = (n + W - 1) / W;
    float ll = 0.f;
    for (int c = 0; c < chunks; ++c) {
        const int j0 = c * W;
        float acc[W];
#pragma unroll
        for (int j = 0; j < W; ++j) acc[j] = 0.f;
        for (int base = 0; base < rows; base += 32 * R) {
            int xo[R];
            float lg[R], res[R];
#pragma unroll
            for (int t = 0; t < R; ++t) {
                xo[t] = min(base + 32 * t + lane, rows - 1) * ldx;
                lg[t] = 0.f;
            }
            for (int k = 0; k < n; ++k) {
                const float qk = q[k];
#pragma unroll
                for (int t = 0; t < R; ++t) lg[t] = fmaf(qk, X[xo[t] + k], lg[t]);
            }
#pragma unroll
            for (int t = 0; t < R; ++t) {
                const int r = base + 32 * t + lane;
                res[t] = 0.f;
                if (r < rows) {
                    const float yr = y[r];
                    const float e = expf(-fabsf(lg[t]));
                    if (c == 0) ll += yr * lg[t] - (fmaxf(lg[t], 0.f) + log1pf(e));
                    res[t] = yr - (lg[t] >= 0.f ? 1.f / (1.f + e) : e / (1.f + e));
                }
            }
#pragma unroll
            for (int t = 0; t < R; ++t) {
#pragma unroll
                for (int j = 0; j < W; ++j)
                    if (j0 + j < n) acc[j] = fmaf(res[t], X[xo[t] + j0 + j], acc[j]);
            }
        }
        const float s = reduce_scatter<W>(acc, lane);
        if (lane < W && j0 + lane < n) g[j0 + lane] = s;
    }
    return ll;
}

'''


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from littlemcmc_torch.models import LogisticRegression
    from littlemcmc_torch.ops import _build
    from littlemcmc_torch.ops.nuts_trajectory import trajectory

    cur = _build._CSRC
    var = ROOT / "build" / "logistic_chunk_order_variant"
    shutil.rmtree(var, ignore_errors=True)
    shutil.copytree(cur, var)
    h = (var / "nuts_transition.cuh").read_text()
    start = h.index("__device__ __forceinline__ float logistic_rows(")
    end = h.index("}  // namespace lmc\n\n// The generated body")
    (var / "nuts_transition.cuh").write_text(h[:start] + VARIANT_BODY + h[end:])

    def use(src):
        _build._CSRC = src
        _build._build_static.cache_clear()
        _build.load_library.cache_clear()
        _build.build_all()

    def design(n, rows=1000):
        rng = np.random.RandomState(n + rows)
        X = rng.standard_normal((rows, n - 1))
        beta = rng.standard_normal(n - 1) * 1.5 / np.sqrt(n - 1)
        y = (rng.uniform(size=rows) < 1.0 / (1.0 + np.exp(-(X @ beta)))).astype(np.float64)
        return LogisticRegression(X, y)

    models = {n: design(n) for n in (40, 256)}
    models[25] = LogisticRegression()
    inputs = {n: chip_smoke._posterior_inputs(m, 1024, 0.25, seed=n) for n, m in models.items()}
    for name in ("sources", "variant", "variant", "sources"):
        use(cur if name == "sources" else var)
        row = {}
        for n, m in sorted(models.items()):
            kw = dict(spec=m.trajectory_spec(), max_treedepth=10, Emax=1000.0, chain_block=8)
            out = trajectory(*inputs[n], (5, 7), **kw)
            row[f"n{n}_leaves"] = float(out["n_leaves"].float().mean())
            row[f"n{n}_ms"] = chip_smoke._cuda_time_ms(
                lambda: trajectory(*inputs[n], (5, 7), **kw), reps=10, warmup=2)
            row[f"n{n}_q_sum"] = float(out["q"].double().sum())
        print(json.dumps({"sources": name, **row}), flush=True)
    for d in sorted((ROOT / "build" / "littlemcmc_torch").iterdir()):
        f = d / "nuts_trajectory.log"
        if f.exists():
            txt = f.read_text().splitlines()
            for i, ln in enumerate(txt):
                if "nuts_trajectory_kernelILi3ELi0E" in ln:
                    print(d.name, txt[i + 1].strip(), txt[i + 2].strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
