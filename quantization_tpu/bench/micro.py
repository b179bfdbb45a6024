"""Criterion-equivalent microbenchmarks.

Reproduces the reference's three criterion bench configs
(demos/benches/{encode,pq,binary}.rs: 100k x 1024-d, SQ dot & L1, PQ with
chunk_size=2, BQ both word tiers) as steady-state device throughput, each
against an unquantized f32 matmul baseline at default matmul precision
(TF32 on GPUs that have it; the stand-in for the AVX f32 kernels of
demos/src/metrics/).

The reference also distinguishes linear vs random access order — a CPU
cache effect with no analogue here (batch scoring reads the whole code
matrix either way), so each config here is one number.

Run: python -m quantization_tpu.bench.micro [--n N] [--d D] [--q Q]
Prints one JSON line per config, each naming the device it ran on.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..utils.profiling import timed


def _timeit(fn, iters=20, warmup=3):
    return timed(fn, iters=iters, warmup=warmup)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--q", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    import quantization_tpu as qt
    from ..utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()

    N, D, Q, K = args.n, args.d, args.q, args.k
    rng = np.random.default_rng(42)
    data = rng.random((N, D), np.float32) * 2 - 1
    queries = rng.random((Q, D), np.float32) * 2 - 1

    data_dev = jnp.asarray(data)
    queries_dev = jnp.asarray(queries)

    @jax.jit
    def f32_search(q, x):
        return jax.lax.top_k(q @ x.T, K)

    t_f32 = _timeit(lambda: f32_search(queries_dev, data_dev))

    dev = jax.devices()[0]

    def emit(name, t, extra=None):
        row = {
            "bench": name,
            "device": dev.device_kind,
            "qps": round(Q / t, 1),
            "ms_per_batch": round(t * 1e3, 3),
            "vs_f32": round(t_f32 / t, 3),
            "n": N, "d": D, "q": Q,
        }
        if extra:
            row.update(extra)
        print(json.dumps(row), flush=True)

    emit("f32_dot", t_f32, {"precision": "default"})

    # --- SQ u8, dot & L1 (demos/benches/encode.rs) ---
    for dt, name in [(qt.DistanceType.DOT, "sq_u8_dot"),
                     (qt.DistanceType.L1, "sq_u8_l1")]:
        params = qt.VectorParameters(D, N, dt, False)
        t0 = time.perf_counter()
        enc = qt.ScalarQuantizerU8.encode(data, params)
        enc_s = time.perf_counter() - t0
        eq = enc.encode_query(queries)
        t = _timeit(lambda: enc.top_k_device(eq, K))
        emit(name, t, {"encode_s": round(enc_s, 2)})

    # --- PQ chunk_size=2 (demos/benches/pq.rs) ---
    params = qt.VectorParameters(D, N, qt.DistanceType.DOT, False)
    t0 = time.perf_counter()
    pq = qt.ProductQuantizer.encode(data, params, chunk_size=2)
    enc_s = time.perf_counter() - t0
    eqp = pq.encode_query(queries)
    t = _timeit(lambda: pq.top_k_device(eqp, K), iters=5)
    emit("pq_chunk2", t, {"encode_s": round(enc_s, 2),
                          "chunks": pq.num_chunks})

    # --- BQ, both word tiers (demos/benches/binary.rs; tiers differ only in
    # on-disk row size — device scoring is identical bit-planes) ---
    for tier in ("u8", "u128"):
        t0 = time.perf_counter()
        bq = qt.BinaryQuantizer.encode(data, params, store_type=tier)
        enc_s = time.perf_counter() - t0
        eqb = bq.encode_query(queries)
        t = _timeit(lambda: bq.top_k_device(eqb, K))
        emit(f"bq_{tier}", t, {"encode_s": round(enc_s, 2)})


if __name__ == "__main__":
    main()
