"""CPU reference baseline measurement.

Rust is not available in this environment, so the reference crate cannot be
built; instead the native C++ scan kernels (g++ -O3 -march=native, the same
autovectorized loops the reference's cc-built C kernels compile to) measure
single-core CPU scoring QPS, the CPU side of a device-vs-CPU comparison.

Run: python -m quantization_tpu.bench.cpu_baseline [N] [D]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def measure(n: int = 100_000, d: int = 1024, iters: int = 5) -> dict:
    from ..core.types import DistanceType, VectorParameters
    from ..models.sq import ScalarQuantizerU8
    from ..native import loader

    if not loader.available():
        raise SystemExit("native toolchain unavailable")

    rng = np.random.default_rng(42)
    data = rng.random((n, d), dtype=np.float32) * 2 - 1
    query = rng.random((d,), dtype=np.float32) * 2 - 1

    params = VectorParameters(d, n, DistanceType.DOT, False)
    enc = ScalarQuantizerU8.encode(data, params, use_native=True)
    m = enc.metadata
    codes = np.asarray(enc.codes[: enc.count]).view(np.uint8)
    voff = np.asarray(enc.voffsets[: enc.count])
    eq = enc.encode_query(query)
    qcodes = np.asarray(eq.codes)[0].view(np.uint8)
    qoff = float(np.asarray(eq.offsets)[0])

    def timeit(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters

    t_u8 = timeit(
        lambda: loader.cpu_scan_dot_u8(qcodes, codes, m.multiplier, qoff, voff)
    )
    t_f32 = timeit(lambda: loader.cpu_scan_dot_f32(query, data))

    return {
        "cpu_sq_u8_scan_qps": 1.0 / t_u8,
        "cpu_f32_scan_qps": 1.0 / t_f32,
        "cpu_u8_vs_f32": t_f32 / t_u8,
        "n": n,
        "dim": d,
    }


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    d = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
    print(json.dumps(measure(n, d)))
