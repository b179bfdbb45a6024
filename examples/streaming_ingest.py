"""Streaming single-pass ingestion at a scale beyond host memory.

Builds SQ, BQ, and PQ indexes over an N x D corpus that NEVER exists in host
RAM (batches are generated, uploaded once, encoded on device into
preallocated buffers, and discarded), then serves top-k from all three plus
a two-stage BQ->SQ pipeline, reporting throughput and recall against the
exact f32 ground truth — which is computed incrementally on the same
uploaded batches, so the f32 data crosses the host->device link exactly
once.

This is the device-side answer to the reference's streaming encode from a
re-cloneable iterator (encoded_vectors_u8.rs:35, SURVEY.md §7 hard part 5),
scaled to corpora where neither the f32 data (30GB at 10M x 768) nor the
[Q, N] score matrix fit anywhere: scoring blocks the corpus
(ops/topk.py blocked_topk).

    python examples/streaming_ingest.py --n 10000000 --d 768
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--batch", type=int, default=131072)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--chunk-size", type=int, default=8)
    ap.add_argument("--clusters", type=int, default=1024)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import quantization_tpu as qt
    from quantization_tpu.models.pq import PQMetadata
    from quantization_tpu.models.sq import SQMetadata
    from quantization_tpu.models.bq import BQMetadata
    from quantization_tpu.ops import pq as pq_ops
    from quantization_tpu.ops import sq as sq_ops
    from quantization_tpu.ops.kmeans import kmeans_batched
    from quantization_tpu.utils.compile_cache import enable_compilation_cache
    from quantization_tpu.utils.device_store import DeviceAppender

    enable_compilation_cache()

    N, D, B, Q, K = args.n, args.d, args.batch, args.queries, args.k
    assert D % args.chunk_size == 0, "demo wants D divisible by chunk size"
    m = D // args.chunk_size
    nb = -(-N // B)

    # --- seeded clustered generator: batch i is reproducible in isolation ---
    centers = (
        np.random.default_rng(7).random((args.clusters, D), np.float32) * 2 - 1
    )

    # Preallocated double buffers, filled IN PLACE: on lazily-backed VMs,
    # faulting fresh pages runs at single-digit MB/s while rewriting
    # resident pages runs at GB/s (measured: 4 vs 2500 MB/s) — per-batch
    # fresh allocations turn generation into hours. Two buffers so the
    # previous batch stays intact while jax serializes its upload.
    _gen_bufs = [np.empty((B, D), np.float32) for _ in range(2)]
    _noise_buf = np.empty((B, D), np.float32)

    def gen(i: int) -> np.ndarray:
        # Symmetric per-point noise at a scale comparable to the centers:
        # sign bits then vary within a cluster, so BQ/PQ recall reflects
        # within-cluster ranking, not just cluster identification.
        rng = np.random.default_rng(1000 + i)
        rows = min(B, N - i * B)
        assign = rng.integers(0, args.clusters, rows)
        out = _gen_bufs[i % 2][:rows]
        noise = _noise_buf[:rows]
        rng.standard_normal(dtype=np.float32, out=noise)
        np.take(centers, assign, axis=0, out=out)
        noise *= 0.5
        out += noise
        return out

    queries = (
        centers[np.random.default_rng(2).integers(0, args.clusters, Q)]
        + np.random.default_rng(3).standard_normal((Q, D), np.float32) * 0.5
    ).astype(np.float32)

    # --- pass 0 (host only): SQ min/max calibration + PQ training sample ---
    t0 = time.perf_counter()
    mn, mx = np.inf, -np.inf
    stride = max(1, N // 10_000)
    sample = []
    for i in range(nb):
        b = gen(i)
        mn = min(mn, float(b.min()))
        mx = max(mx, float(b.max()))
        sample.append(b[::stride].copy())  # b is a reused buffer view
    sample = np.concatenate(sample)[:10_000]
    print(f"pass0 (calibration scan, host): {time.perf_counter()-t0:.0f}s")

    # --- PQ training on the sample (batched k-means on device) ---
    t0 = time.perf_counter()
    division = pq_ops.get_vector_division(D, args.chunk_size)
    sample_chunks = jnp.asarray(pq_ops.chunk_tensor(sample, division))
    cent_chunks = kmeans_batched(sample_chunks, pq_ops.CENTROIDS_COUNT)
    centroids = pq_ops.chunks_to_centroids(np.asarray(cent_chunks), division, D)
    print(f"PQ k-means ({m} chunks x 256): {time.perf_counter()-t0:.0f}s")

    # --- pass 1 (the single upload pass): encode SQ+BQ+PQ, running exact GT ---
    params_dot = qt.VectorParameters(D, N, qt.DistanceType.DOT, False)
    alpha, offset = sq_ops.alpha_offset_from_min_max(mn, mx)
    actual = sq_ops.actual_dim(D)
    lane = sq_ops.lane_dim(D)
    npad = N + (-N) % sq_ops.ROW_ALIGN
    w = -(-D // 32)
    w8 = w + (-w) % 8
    dp = w8 * 32

    sq_codes = DeviceAppender((npad, lane), jnp.int8)
    sq_voff = DeviceAppender((npad,), jnp.float32)
    bq_planes_t = DeviceAppender((npad, w8), jnp.uint32)
    pq_codes = DeviceAppender((npad, m), jnp.uint8)

    pow2 = jnp.left_shift(
        jnp.uint32(1), jnp.arange(32, dtype=jnp.uint32)
    )

    @jax.jit
    def pack_bits_dev(x):  # [B, D] f32 -> uint32 [B, w8] (LSB-first)
        bits = (x > 0).astype(jnp.uint32)
        bits = jnp.pad(bits, ((0, 0), (0, dp - D)))
        return jnp.sum(
            bits.reshape(-1, w8, 32) * pow2[None, None, :],
            axis=2,
            dtype=jnp.uint32,
        )

    cents_dev = jnp.asarray(
        pq_ops.centroids_to_chunks(centroids, division)
    )  # [m, 256, c]

    @jax.jit
    def gt_update(best_s, best_i, xb, base):
        s = queries_dev @ xb.T  # exact f32 oracle on the already-uploaded batch
        ii = base + jnp.arange(xb.shape[0], dtype=jnp.int32)
        cs = jnp.concatenate([best_s, s], axis=1)
        ci = jnp.concatenate(
            [best_i, jnp.broadcast_to(ii[None, :], s.shape)], axis=1
        )
        ts, tp = jax.lax.top_k(cs, K)
        return ts, jnp.take_along_axis(ci, tp, axis=1)

    queries_dev = jnp.asarray(queries)
    best_s = jnp.full((Q, K), -np.inf, jnp.float32)
    best_i = jnp.full((Q, K), -1, jnp.int32)

    t0 = time.perf_counter()
    for i in range(nb):
        hb = gen(i)
        xb = jnp.asarray(hb)  # the one upload
        codes, voff = sq_ops.quantize_batch(
            xb, alpha=alpha, offset=offset,
            distance_type=qt.DistanceType.DOT, invert=False, dpad=actual,
            lane=lane,
        )
        sq_codes.append(codes)
        sq_voff.append(voff)
        bq_planes_t.append(pack_bits_dev(xb))
        xc = jnp.transpose(
            xb.reshape(-1, m, args.chunk_size), (1, 0, 2)
        )  # [m, B, c] on device
        pq_codes.append(pq_ops.encode_batch(xc, cents_dev).astype(jnp.uint8))
        best_s, best_i = gt_update(best_s, best_i, xb, jnp.int32(i * B))
        if i % 16 == 0:
            jax.block_until_ready(best_s)
            print(f"  batch {i+1}/{nb}", end="\r", flush=True)
    jax.block_until_ready(best_s)
    dt = time.perf_counter() - t0
    print(f"pass1 (upload+encode x3+GT): {dt:.0f}s  "
          f"({N/dt:.0f} vec/s, {N*D*4/dt/2**30:.2f} GiB/s up)")

    # --- assemble the quantizers from the device buffers ---
    mult = sq_ops.multiplier_for(qt.DistanceType.DOT, False, alpha)
    sq = qt.ScalarQuantizerU8(
        sq_codes.finish(), sq_voff.finish(),
        SQMetadata(actual, alpha, offset, mult, params_dot),
    )
    bq = qt.BinaryQuantizer(
        jnp.transpose(bq_planes_t.finish()), BQMetadata(params_dot)
    )
    pq = qt.ProductQuantizer(
        pq_codes.finish(),
        PQMetadata(centroids, division, params_dot),
    )

    # --- serve + measure (pipelined throughput, like bench.py) ---
    def timeit(fn, iters=20):
        r = fn()
        np.asarray(jax.tree_util.tree_leaves(r)[0])
        t0 = time.perf_counter()
        for _ in range(iters):
            r = fn()
        np.asarray(jax.tree_util.tree_leaves(r)[0])
        return (time.perf_counter() - t0) / iters

    gt = np.asarray(best_i)

    def recall(ids):
        ids = np.asarray(ids)
        return float(np.mean([
            len(set(ids[r].tolist()) & set(gt[r].tolist())) / K
            for r in range(Q)
        ]))

    eq_sq = sq.encode_query(queries)
    eq_bq = bq.encode_query(queries)
    eq_pq = pq.encode_query(queries)
    two = qt.TwoStageIndex(bq, sq, oversampling=8.0)

    for name, fn in [
        ("SQ full-scan", lambda: sq.top_k_device(eq_sq, K)),
        ("BQ full-scan", lambda: bq.top_k_device(eq_bq, K)),
        ("PQ full-scan", lambda: pq.top_k_device(eq_pq, K)),
        ("two-stage BQ->SQ", lambda: two.top_k_device((eq_bq, eq_sq), K)),
    ]:
        t = timeit(fn)
        _, ids = fn()
        print(f"{name:22s}: {Q/t:10.0f} qps  ({t*1e3:6.2f} ms/batch)  "
              f"recall@{K} vs exact = {recall(ids):.3f}")


if __name__ == "__main__":
    main()
