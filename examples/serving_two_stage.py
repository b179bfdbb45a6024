"""Two-stage serving demo: quantized coarse search + original-vector rescore.

The qdrant serving pattern (the reason quantization exists there: shrink
the resident index, then buy recall back by rescoring a few dozen
survivors with the original f32 vectors). On a seeded 10M corpus, SQ
coarse top-(ov*k) -> f32 rescore reached recall@10 0.991.

This demo builds it from public parts over a 100k x 768 corpus (pass
--n 1000000 or more for a deployment-sized corpus):

    ScalarQuantizerU8.encode(...)            # 8-bit resident codes
    ExactRescorer(data, ...)                 # f32 rescoring stage
    TwoStageIndex(coarse, fine, oversampling=4)
    index.top_k(index.encode_query(q), 10)

and reports recall@10 against the exact f32 scan plus steady-state
throughput.

    python examples/serving_two_stage.py [--n 500000] [--d 768]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--oversampling", type=float, default=4.0)
    args = ap.parse_args()

    import jax

    from quantization_tpu import (
        DistanceType,
        ScalarQuantizerU8,
        VectorParameters,
    )
    from quantization_tpu.models.pipeline import ExactRescorer, TwoStageIndex
    from quantization_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    n, d, q, k = args.n, args.d, args.queries, args.k
    rng = np.random.default_rng(7)
    data = rng.standard_normal((n, d)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)

    params = VectorParameters(d, n, DistanceType.DOT, False)
    t0 = time.perf_counter()
    coarse = ScalarQuantizerU8.encode(data, params)
    fine = ExactRescorer(data, DistanceType.DOT, invert=False)
    index = TwoStageIndex(
        coarse, fine, oversampling=args.oversampling, coarse_method="approx"
    )
    print(f"encode: {time.perf_counter() - t0:.1f}s "
          f"({n / (time.perf_counter() - t0):,.0f} vec/s)")

    eq = index.encode_query(queries)
    scores, ids = index.top_k_device(eq, k)
    ids_np = np.asarray(ids)

    # exact f32 ground truth on device
    import jax.numpy as jnp

    gt_scores = jnp.asarray(queries) @ jnp.asarray(data).T
    _, gt = jax.lax.top_k(gt_scores, k)
    gt_np = np.asarray(gt)
    recall = np.mean([
        len(set(ids_np[r]) & set(gt_np[r])) / k for r in range(q)
    ])
    print(f"recall@{k} vs exact f32: {recall:.3f} "
          f"(coarse oversampling {args.oversampling:g} -> "
          f"R={int(args.oversampling * k)})")

    # steady-state throughput: enqueue many, drain once
    def run():
        return index.top_k_device(eq, k)

    r = run()
    np.asarray(jax.tree_util.tree_leaves(r)[0])
    iters = 20
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            r = run()
        np.asarray(jax.tree_util.tree_leaves(r)[0])
        best = min(best, (time.perf_counter() - t0) / iters)
    print(f"serve: {best * 1e3:.2f} ms/batch ({q / best:,.0f} qps, "
          f"Q={q}, N={n:,})")
    assert recall >= 0.9, "two-stage recall should beat the coarse stage"
    print("OK")


if __name__ == "__main__":
    main()
