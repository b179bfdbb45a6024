#!/usr/bin/env python
"""Headline benchmark: SQ-u8 batched scoring + top-10 vs the unquantized f32
baseline, 100k x 1024-d (the reference's criterion `encode` bench config,
demos/benches/encode.rs:15-16, with the f32 SIMD baselines of
demos/src/metrics/ replaced by a plain jnp f32 matmul at default matmul
precision, which is TF32 on GPUs that have it).

Both sides run score + top-k as one jitted search program per query batch;
the quantized side scores through the production path
(``ScalarQuantizerU8.top_k_device``). Each timed call ends in
``jax.block_until_ready``; the median of ``ITERS`` calls is reported.

Prints ONE JSON line:
  {"metric": ..., "value": qps, "unit": "queries/s", "vs_baseline": x_f32,
   "device": device_kind}
Extended per-stage timings go to stderr.
"""

import json
import sys

import numpy as np

N, D, Q, K = 100_000, 1024, 256, 10
ITERS = 20


def main():
    import jax
    import jax.numpy as jnp

    from quantization_tpu import DistanceType, ScalarQuantizerU8, VectorParameters
    from quantization_tpu.ops.topk import topk_exact
    from quantization_tpu.utils.compile_cache import enable_compilation_cache
    from quantization_tpu.utils.profiling import timed

    enable_compilation_cache()

    rng = np.random.default_rng(42)
    data = rng.random((N, D), dtype=np.float32) * 2.0 - 1.0
    queries = rng.random((Q, D), dtype=np.float32) * 2.0 - 1.0

    params = VectorParameters(D, N, DistanceType.DOT, False)
    enc = ScalarQuantizerU8.encode(data, params)
    eq = enc.encode_query(queries)

    data_dev = jnp.asarray(data)
    queries_dev = jnp.asarray(queries)

    @jax.jit
    def f32_search(q, x):
        return topk_exact(q @ x.T, K)

    t_quant = timed(lambda: enc.top_k_device(eq, K), iters=ITERS, warmup=3)
    t_f32 = timed(f32_search, queries_dev, data_dev, iters=ITERS, warmup=3)

    dev = jax.devices()[0]
    qps = Q / t_quant
    qps_f32 = Q / t_f32
    print(
        f"quantized: {t_quant * 1e3:.3f} ms/batch  "
        f"f32: {t_f32 * 1e3:.3f} ms/batch  (Q={Q}, N={N}, D={D}, "
        f"device={dev.platform}/{dev.device_kind})",
        file=sys.stderr,
    )
    print(
        json.dumps(
            {
                "metric": "sq_u8_dot_top10_qps_100k_x_1024",
                "value": round(qps, 1),
                "unit": "queries/s",
                "vs_baseline": round(qps / qps_f32, 3),
                "device": dev.device_kind,
            }
        )
    )


if __name__ == "__main__":
    main()
