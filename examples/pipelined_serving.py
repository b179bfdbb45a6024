"""Pipelined serving-loop demo: PipelinedSearcher over a calibrated plan.

The deployment shape (serving.py):
request batches stream in, the searcher keeps ``depth`` searches in
flight on the device stream, and results come back FIFO one pipeline
stage behind. A blocking ``top_k`` per request pays a full dispatch+sync
bubble per call; the pipelined loop approaches the device time.

Built entirely from public parts:

    recommend(index, target_recall, queries=sample, data=data)
    plan.serve(index, data, depth=8)       # -> PipelinedSearcher
    for scores, ids in searcher.search_stream(request_batches): ...

    python examples/pipelined_serving.py [--n 200000] [--target 0.95]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--queries", type=int, default=32)
    ap.add_argument("--batches", type=int, default=24)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--target", type=float, default=0.95)
    args = ap.parse_args()

    from quantization_tpu import (
        DistanceType,
        IVFIndex,
        VectorParameters,
        exact_topk,
        recall_at_k,
        recommend,
    )
    from quantization_tpu.utils.compile_cache import (
        enable_compilation_cache,
    )

    enable_compilation_cache()
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((256, args.d)).astype(np.float32)
    assign = rng.integers(0, 256, args.n)
    data = (
        centers[assign]
        + 0.3 * rng.standard_normal((args.n, args.d)).astype(np.float32)
    ).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    params = VectorParameters(
        args.d, args.n, DistanceType.DOT, invert=False
    )

    t0 = time.perf_counter()
    ivf = IVFIndex.encode(data, params, quantizer="sq")  # auto geometry
    print(f"IVF-SQ build: {time.perf_counter()-t0:.1f}s "
          f"(nlist={ivf.metadata.nlist}, S={ivf.metadata.bucket_size})")

    sample_q = data[rng.choice(args.n, args.queries, replace=False)]
    t0 = time.perf_counter()
    plan = recommend(
        ivf, args.target, k=args.k, queries=sample_q, data=data,
        q_batch=args.queries,
    )
    print(f"calibrated plan in {time.perf_counter()-t0:.1f}s: "
          f"nscan={plan.nscan} ov={plan.oversampling:g} "
          f"measured recall {plan.expected_recall:.3f}")

    searcher = plan.serve(ivf, data, k=args.k, depth=8)

    # Request stream: args.batches independent query batches.
    reqs = [
        (data[rng.choice(args.n, args.queries, replace=False)]
         + 0.01 * rng.standard_normal(
             (args.queries, args.d)).astype(np.float32))
        for _ in range(args.batches)
    ]
    searcher.warmup(reqs[0])
    t0 = time.perf_counter()
    results = list(searcher.search_stream(reqs))
    dt = time.perf_counter() - t0
    nq = args.batches * args.queries
    print(f"served {nq} queries in {dt*1e3:.0f} ms "
          f"({nq/dt:,.0f} qps pipelined, depth=8)")

    # Quality check on the last batch.
    _, gt = exact_topk(
        reqs[-1], data, params.distance_type, params.invert, args.k
    )
    r = recall_at_k(results[-1][1], np.asarray(gt))
    print(f"recall@{args.k} on the last batch: {r:.3f}")


if __name__ == "__main__":
    main()
