"""ANN benchmark CLI — the JAX port of demos/src/ann_benchmark.rs.

Flags mirror the reference's clap interface (ann_benchmark.rs:20-44):
  --dataset SUBSTR   filter the 11-dataset registry
  --method  u8|pq|bq|bq-u8|bq-exact|u8-f32  quantizer (+ optional
            rescoring stage; u8-f32 = SQ-approx coarse -> original-vector
            rescore, the highest-recall serving config on seeded
            corpora)
  --quantile F       SQ quantile calibration
  --chunk-size N     PQ chunk size
  --pq-bits 4|8      PQ code width (4-bit halves bytes, 16-entry LUTs)
  --opq              learn an OPQ rotation before PQ chunking (ops/opq.py —
                     beyond the reference; large recall gains on low-rank
                     embedding distributions at identical search cost)
  --nlist/--nprobe/--bucket-size  IVF geometry for the ivf-* methods
                     (ivf-sq | ivf-pq | ivf-pq-f32 — probe-limited bucket
                     scans, models/ivf.py; beyond the reference. --opq
                     composes: ivf-pq --opq rotates inside the buckets)
  --test-acc         measure recall@10/20/30 + latency percentiles
  --bench            measure quantized scoring throughput
  --bench-f32        measure the unquantized f32 baseline (the device analog
                     of --bench_simd and demos/src/metrics/)
  --query-batch N    queries per device call (the batching axis)

Datasets load from --data-dir when the ann-benchmarks HDF5 file exists there,
else fall back to a seeded synthetic corpus of the same shape (zero-egress
environments).

Latency note: with the default --query-batch 1, each query pays its own
dispatch and host round trip (per the reference's per-query loop). Use
--query-batch 64+ for engine-limited numbers; recall is
batch-size-invariant.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..core.types import DistanceType, VectorParameters
from .ann_data import DATASETS, AnnBenchmarkData, test_knn


def build_index(method: str, data: AnnBenchmarkData, args):
    from ..models.bq import BinaryQuantizer
    from ..models.pipeline import ExactRescorer, TwoStageIndex
    from ..models.pq import ProductQuantizer
    from ..models.sq import ScalarQuantizerU8

    n, dim = data.train.shape
    invert = data.distance_type != DistanceType.DOT
    params = VectorParameters(dim, n, data.distance_type, invert)
    t0 = time.perf_counter()
    if method == "u8":
        index = ScalarQuantizerU8.encode(
            data.train, params, quantile=args.quantile
        )
    elif method == "pq":
        index = ProductQuantizer.encode(
            data.train, params, chunk_size=args.chunk_size,
            bits=args.pq_bits,
            rotation="opq" if args.opq else None,
        )
    elif method == "bq":
        index = BinaryQuantizer.encode(data.train, params)
    elif method == "bq-u8":
        coarse = BinaryQuantizer.encode(data.train, params)
        fine = ScalarQuantizerU8.encode(
            data.train, params, quantile=args.quantile
        )
        index = TwoStageIndex(coarse, fine, oversampling=args.oversampling)
    elif method == "bq-exact":
        coarse = BinaryQuantizer.encode(data.train, params)
        fine = ExactRescorer(data.train, data.distance_type, invert)
        index = TwoStageIndex(coarse, fine, oversampling=args.oversampling)
    elif method.startswith("ivf-"):
        from ..models.ivf import IVFIndex

        kind = method.split("-")[1]  # ivf-<kind>[-f32]
        kw = {}
        if kind == "sq":
            kw["quantile"] = args.quantile
        elif kind == "pq":
            kw["chunk_size"] = args.chunk_size
            kw["bits"] = args.pq_bits
            if args.opq:
                kw["rotation"] = "opq"
        index = IVFIndex.encode(
            data.train, params, quantizer=kind, nlist=args.nlist,
            bucket_size=args.bucket_size, nprobe=args.nprobe,
            nscan=args.nscan, residual=args.residual, **kw,
        )
        if method.endswith("-f32"):
            fine = ExactRescorer(data.train, data.distance_type, invert)
            index = TwoStageIndex(
                index, fine, oversampling=args.oversampling,
                coarse_method="approx",
            )
    elif method == "u8-f32":
        # The serving headline: SQ coarse -> rescore the survivors with
        # the ORIGINAL f32 vectors.
        coarse = ScalarQuantizerU8.encode(
            data.train, params, quantile=args.quantile
        )
        fine = ExactRescorer(data.train, data.distance_type, invert)
        index = TwoStageIndex(
            coarse, fine, oversampling=args.oversampling,
            coarse_method="approx",
        )
    else:
        raise SystemExit(f"unknown method {method!r}")
    if getattr(args, "sharded", False):
        index = _shard_index(index, data)
    encode_s = time.perf_counter() - t0
    print(f"[{data.name}] {method} encode: {encode_s:.2f}s "
          f"({n / max(encode_s, 1e-9):,.0f} vectors/s)")
    return index


def _shard_index(index, data):
    """Re-lay the index over all available devices (--sharded): corpus axis
    sharded via shard_map, local top-k merged with one all_gather per
    query batch. A 1-device mesh degenerates to the single-chip path."""
    from ..models.bq import BinaryQuantizer
    from ..models.pipeline import ExactRescorer, TwoStageIndex
    from ..models.pq import ProductQuantizer
    from ..models.sq import ScalarQuantizerU8
    from ..parallel.sharded import (
        ShardedBinaryQuantizer,
        ShardedExactRescorer,
        ShardedProductQuantizer,
        ShardedScalarQuantizer,
        make_mesh,
    )

    mesh = make_mesh()

    def wrap(ix):
        from ..models.ivf import IVFIndex
        from ..parallel.sharded_ivf import ShardedIVF

        if isinstance(ix, IVFIndex):
            return ShardedIVF(ix, mesh)
        if isinstance(ix, ScalarQuantizerU8):
            return ShardedScalarQuantizer(ix, mesh)
        if isinstance(ix, BinaryQuantizer):
            return ShardedBinaryQuantizer(ix, mesh)
        if isinstance(ix, ProductQuantizer):
            return ShardedProductQuantizer(ix, mesh)
        if isinstance(ix, ExactRescorer):
            invert = data.distance_type != DistanceType.DOT
            return ShardedExactRescorer(
                data.train, data.distance_type, invert, mesh
            )
        return ix

    if isinstance(index, TwoStageIndex):
        return TwoStageIndex(
            wrap(index.coarse), wrap(index.fine),
            oversampling=index.oversampling,
            coarse_method=index.coarse_method,
        )
    return wrap(index)


def bench_scoring(data: AnnBenchmarkData, index, args, label: str):
    """Quantized full-scan scoring throughput (reference --bench path,
    ann_benchmark.rs:245-261). Indexes without a dense ``score_batch``
    (sharded wrappers, two-stage pipelines) bench the SEARCH path
    (``top_k_device``) instead — the serving-relevant number."""
    import jax

    q = data.test[: args.query_batch]
    eq = index.encode_query(q)
    iters = max(args.iters, 1)

    if not hasattr(index, "score_batch"):
        # Serving path: measure THROUGH the public PipelinedSearcher
        # (the packaged chained-dispatch loop, serving.py) — each
        # steady-state submit drains the oldest in-flight result.
        from ..serving import PipelinedSearcher

        # materialize=False: the window times device searches, not the
        # host conversion of their results.
        s = PipelinedSearcher(index, k=10, depth=8, materialize=False)
        s.warmup(eq, encoded=True)
        for _ in range(8):
            s.submit(eq, encoded=True)
        s.sync()  # fill completes outside the timed window
        t0 = time.perf_counter()
        for _ in range(iters):
            s.submit(eq, encoded=True)
        s.sync()  # window = exactly `iters` searches
        dt = (time.perf_counter() - t0) / iters
        for _ in s.flush():
            pass
        label = f"{label} search-top10"
    else:
        def run():
            return index.score_batch(eq)

        from ..utils.profiling import timed

        dt = timed(run, iters=iters, warmup=1)
    n = data.train.shape[0]
    qps = q.shape[0] / dt
    pairs_ps = q.shape[0] * n / dt
    print(
        f"[{data.name}] {label} scoring: {qps:,.0f} q/s, "
        f"{pairs_ps / 1e9:.2f}G pairs/s (batch={q.shape[0]}, N={n})"
    )
    return qps


def bench_f32(data: AnnBenchmarkData, args):
    """Unquantized f32 baseline: the exact scorer at HIGHEST matmul
    precision (core.distances; the device analog of
    demos/src/metrics/)."""
    import jax
    import jax.numpy as jnp

    from ..core.distances import pairwise_score

    invert = data.distance_type != DistanceType.DOT
    train = jnp.asarray(data.train)
    q = jnp.asarray(data.test[: args.query_batch])

    @jax.jit
    def run_fn(qq):
        return pairwise_score(qq, train, data.distance_type, invert)

    from ..utils.profiling import timed

    dt = timed(run_fn, q, iters=max(args.iters, 1), warmup=1)
    qps = q.shape[0] / dt
    print(
        f"[{data.name}] f32 baseline scoring: {qps:,.0f} q/s "
        f"(batch={q.shape[0]}, N={data.train.shape[0]})"
    )
    return qps


def main(argv=None):
    from ..utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="", help="substring filter")
    p.add_argument("--method", default="u8",
                   choices=["u8", "pq", "bq", "bq-u8", "bq-exact", "u8-f32",
                            "ivf-sq", "ivf-pq", "ivf-bq", "ivf-sq-f32",
                            "ivf-pq-f32", "ivf-bq-f32"])
    p.add_argument("--quantile", type=float, default=None)
    p.add_argument("--chunk-size", type=int, default=2)
    p.add_argument("--pq-bits", type=int, default=8, choices=[4, 8],
                   help="PQ code width: 8 = reference parity, 4 = Quick-ADC")
    p.add_argument("--opq", action="store_true",
                   help="learn an OPQ rotation before PQ chunking")
    p.add_argument("--auto-config", type=float, default=None,
                   metavar="TARGET_RECALL",
                   help="calibrate a serving plan to this recall@10 on a "
                   "query sample (policy.recommend) instead of hand-picked "
                   "--nscan/--oversampling")
    p.add_argument("--nlist", type=int, default=None,
                   help="IVF cluster count (ivf-* methods; "
                   "default: auto_geometry)")
    p.add_argument("--nprobe", type=int, default=32,
                   help="IVF probed buckets per query (ivf-* methods)")
    p.add_argument("--bucket-size", type=int, default=None,
                   help="IVF rows per bucket (ivf-* methods)")
    p.add_argument("--nscan", type=int, default=None,
                   help="IVF batch-union scanned buckets "
                   "(default 4 * nprobe)")
    p.add_argument("--residual", action="store_true",
                   help="IVF inner codes over v - bucket_center (the "
                   "IVF-PQ/IVFADC recipe; ivf-sq / ivf-pq DOT/L2, "
                   "ivf-bq DOT only, bucket-size multiple of 512)")
    p.add_argument("--oversampling", type=float, default=4.0)
    p.add_argument("--test-acc", action="store_true")
    p.add_argument("--bench", action="store_true")
    p.add_argument("--bench-f32", action="store_true")
    p.add_argument("--query-batch", type=int, default=64)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--data-dir", default="test_data")
    p.add_argument("--synthetic-count", type=int, default=100_000)
    p.add_argument("--topk-method", default="exact", choices=["exact", "approx"])
    p.add_argument("--recall-target", type=float, default=None,
                   help="approx mode's recall/speed dial; accepted and "
                   "forwarded, but every top-k method selects exactly "
                   "(ops/topk.py)")
    p.add_argument("--sharded", action="store_true",
                   help="shard the corpus over all available devices")
    p.add_argument("--json", action="store_true", help="emit JSON results")
    args = p.parse_args(argv)

    results = []
    for name, spec in DATASETS.items():
        if args.dataset and args.dataset not in name:
            continue
        data = AnnBenchmarkData.load(
            spec, args.data_dir, synthetic_count=args.synthetic_count
        )
        data.preprocess_cosine()
        index = build_index(args.method, data, args)
        if args.auto_config is not None:
            # Calibrated serving plan (policy.recommend): sweep the
            # nscan/rescore ladder on a query sample against the exact
            # f32 oracle until the target recall is met, then serve
            # through the plan — no hand-picked --nscan/--oversampling.
            from ..models.pipeline import TwoStageIndex
            from ..policy import recommend

            base = index.coarse if isinstance(index, TwoStageIndex) else index
            plan = recommend(
                base, args.auto_config, queries=data.test[:32],
                data=data.train, q_batch=args.query_batch,
            )
            index = plan.build(base, data.train)
            print(
                f"[{data.name}] auto-config: nscan={plan.nscan} "
                f"oversampling={plan.oversampling} "
                f"measured_recall={plan.expected_recall:.3f} ({plan.notes})"
            )
        entry = {"dataset": data.name, "method": args.method}
        if args.test_acc:
            res = test_knn(
                data, index, query_batch=args.query_batch,
                topk_method=args.topk_method,
                recall_target=args.recall_target,
            )
            timings = res.timings()
            print(
                f"[{data.name}] recall: same_10={res.same_10:.4f} "
                f"same_20={res.same_20:.4f} same_30={res.same_30:.4f}"
            )
            print(
                f"[{data.name}] latency/query: "
                + ", ".join(f"{k}={v:,.0f}" for k, v in timings.items())
            )
            entry.update(
                same_10=res.same_10, same_20=res.same_20,
                same_30=res.same_30, **timings,
            )
        if args.bench and (
            hasattr(index, "score_batch") or hasattr(index, "top_k_device")
        ):
            entry["qps"] = bench_scoring(data, index, args, args.method)
        if args.bench_f32:
            entry["f32_qps"] = bench_f32(data, args)
        results.append(entry)
    if args.json:
        print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
