#!/usr/bin/env python
"""Smoke test of the search engine on one NVIDIA GPU (four with ``--four``).

Drives the main path once through the public entry points at the width of
the repo's own deployment (BASELINE.json configs 1 and 2: 1M x 768
embeddings, cosine scored as DOT on row-normalised data), with a seeded
clustered corpus made on the host. Every phase checks its results against a
plain reference and raises on failure; nothing is caught, so any failure
exits non-zero. Times are printed for information only.

    python chip_smoke.py [--seed N]      # one GPU: every single-card phase
    python chip_smoke.py --four          # four GPUs: the sharded engines only

The last line of standard output is one JSON object::

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Without a GPU the script exits 1 after the device phase and prints no
result. Each phase is a function taking its sizes, so the CPU tests drive
them at a tiny size.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# Full-size shapes (BASELINE.json configs 1 and 2).
N, D, Q, K = 1_000_000, 768, 256, 10
BATCHES = 8
PQ_CHUNK = 8  # 768 / 8 = 96 sub-quantizers (config 2)
# --four: config 4's width; rows cut so that host generation and the
# single-card comparison fit one run.
N4, D4 = 2_000_000, 1536

# Recall floors, from CPU rehearsals of these phases at reduced N (same
# generator and seed, 768-d). The corpus is 64 gaussian clusters: inside a
# cluster the nearest neighbours are nearly tied, so quantized scores alone
# rank them poorly and every floor is set by what exact rescoring or the
# probe width allows, well below the rehearsal.
# Two-stage SQ -> exact f32 rescore: recall is lost only where a true
# top-10 row falls outside the SQ top-40 (0.9625 at 100k, 0.9600 at 300k;
# 0.9405 at 1M on an H100).
MIN_RECALL_TWO_STAGE = 0.9
# IVF-SQ at the default nprobe=32, no rescore: the 256 queries share one
# union of 4 * nprobe = 128 buckets, 12% of the rows at 1M, so most
# queries keep only part of their cluster (0.70 at 100k, where the union
# is every bucket; 0.38 at 300k, 36% of the rows; 0.16 at 1M on an H100).
# The search itself is checked exactly against a dense scan over the full
# union.
MIN_RECALL_IVF = 0.05
# BQ / PQ recall without rescoring is printed only: 1-bit and 96-byte
# codes cannot order near-tied neighbours; their scores are checked exactly.
# --four (2M x 1536), where each engine is also held to the single-card
# engine on the same data; rehearsed at 100k x 1536 on 4 CPU devices:
# sharded SQ without rescore (0.78 at 100k; recall falls as N grows;
# 0.71 at 2M on four H100s),
MIN_RECALL_SQ4 = 0.3
# sharded BQ -> SQ two-stage, both stages quantized (0.31 at 100k; 0.068
# at 2M),
MIN_RECALL_BQ_SQ4 = 0.05
# sharded IVF-SQ: the default union is 6.5% of 2M rows (0.75 at 100k,
# where it is every bucket; 0.078 at 2M).
MIN_RECALL_IVF4 = 0.03


class SmokeFailure(AssertionError):
    """A phase's result disagreed with its reference."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def median_ms(fn, reps: int = 5) -> float:
    """Median wall time of ``fn()`` in ms, each call ended by
    ``jax.block_until_ready``; one untimed call first (compilation)."""
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def make_corpus(n: int, dim: int, n_queries: int, seed: int):
    """Row-normalised clustered corpus and queries (cosine as DOT)."""
    from quantization_tpu.bench.ann_data import clustered_corpus, cosine_preprocess

    train, test = clustered_corpus(n, dim, n_queries, seed)
    return cosine_preprocess(train), cosine_preprocess(test)


def oracle_ids(queries, data, k: int) -> np.ndarray:
    """Exact f32 top-k ids at HIGHEST matmul precision (policy.exact_topk)."""
    from quantization_tpu import DistanceType, exact_topk

    _, ids = exact_topk(queries, data, DistanceType.DOT, False, k)
    return np.asarray(ids)


def recall(ids, gt) -> float:
    from quantization_tpu import recall_at_k

    return recall_at_k(ids, gt)


# ----------------------------------------------------------------- phases


def phase_device() -> dict:
    """Report the device; fail unless JAX's default backend is a GPU."""
    import jax

    from quantization_tpu.utils.compile_cache import enable_compilation_cache

    devs = jax.devices()
    d0 = devs[0]
    log("device", f"platform={d0.platform} device_kind={d0.device_kind} count={len(devs)}")
    if d0.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default backend is {d0.platform!r}")
    log("device", f"jax={jax.__version__} compile_cache={enable_compilation_cache()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    for line in smi.stdout.strip().splitlines():
        print(line.strip(), flush=True)
    return {"platform": d0.platform, "kind": d0.device_kind, "count": len(devs)}


def phase_sq_two_stage(data, queries, gt, *, q: int, k: int,
                       min_recall: float = MIN_RECALL_TWO_STAGE) -> dict:
    """SQ-u8 (quantile 0.99) -> exact f32 rescore, served through
    PipelinedSearcher over ``len(queries) // q`` batches."""
    import jax

    from quantization_tpu import (
        DistanceType, ExactRescorer, PipelinedSearcher, ScalarQuantizerU8,
        TwoStageIndex, VectorParameters,
    )

    n, dim = data.shape
    params = VectorParameters(dim, n, DistanceType.DOT, False)
    t0 = time.perf_counter()
    sq = ScalarQuantizerU8.encode(data, params, quantile=0.99)
    jax.block_until_ready(sq.codes)
    log("sq_two_stage", f"encode_s={time.perf_counter() - t0:.3f}")
    two = TwoStageIndex(
        sq, ExactRescorer(data, DistanceType.DOT, False), oversampling=4.0
    )
    batches = [queries[i : i + q] for i in range(0, len(queries), q)]
    searcher = PipelinedSearcher(two, k=k, depth=4)
    ids = np.concatenate([i for _, i in searcher.search_stream(batches)])
    check(ids.shape == (len(queries), k), f"ids shape {ids.shape}")
    rec = recall(ids, gt)
    times = []
    for b in batches:  # first batch compiled above, inside the stream
        t0 = time.perf_counter()
        jax.block_until_ready(two.top_k_device(two.encode_query(b), k))
        times.append((time.perf_counter() - t0) * 1e3)
    log("sq_two_stage", f"recall@{k}={rec:.4f} (min {min_recall}) "
        f"median_batch_ms={np.median(times):.3f} batches={len(batches)} q={q}")
    check(rec >= min_recall, f"two-stage recall {rec:.4f} < {min_recall}")
    # Informational: the stages of one batch, each on its own.
    eq_sq, eq_f32 = two.encode_query(batches[0])
    r = int(np.ceil(k * two.oversampling))
    cand = sq.top_k_device(eq_sq, r)[1]
    stages = {
        f"sq_top{k}": lambda: sq.top_k_device(eq_sq, k),
        f"sq_top{r}": lambda: sq.top_k_device(eq_sq, r),
        "sq_score_candidates": lambda: sq.score_candidates(eq_sq, cand),
        "f32_score_candidates": lambda: two.fine.score_candidates(eq_f32, cand),
    }
    log("sq_two_stage", " ".join(
        f"{name}_ms={median_ms(fn):.3f}" for name, fn in stages.items()
    ))
    return {"sq": sq, "recall": rec, "median_batch_ms": float(np.median(times))}


def phase_sq_exact(*, nq: int, rows: int, dim: int, seed: int) -> dict:
    """``ops.sq.int_dot`` bit-exact vs the integer product, and the HLO the
    dot compiles to."""
    import jax
    import jax.numpy as jnp

    from quantization_tpu.ops import sq as sq_ops

    rng = np.random.default_rng(seed)
    # Codes live in [0, 127]. A hot block of rows and queries drawn from
    # [110, 127] pushes sums past 2^24 (about 2.5e7 at D=1536), where an
    # f32 or TF32 accumulation would round odd totals.
    qc = rng.integers(0, 128, (nq, dim), dtype=np.int8)
    cc = rng.integers(0, 128, (rows, dim), dtype=np.int8)
    qc[:8] = rng.integers(110, 128, (min(8, nq), dim), dtype=np.int8)
    cc[:64] = rng.integers(110, 128, (64, dim), dtype=np.int8)
    got = np.asarray(sq_ops.int_dot(jnp.asarray(qc), jnp.asarray(cc)))
    # float64 BLAS is exact here: every partial sum is an integer < 2^53.
    want = qc.astype(np.float64) @ cc.astype(np.float64).T
    check(got.dtype == np.int32, f"int_dot dtype {got.dtype}")
    check(np.array_equal(got.astype(np.int64), want.astype(np.int64)),
          f"int_dot differs from the integer product at "
          f"{int(np.sum(got != want))} of {got.size} entries")
    log("sq_exact", f"int_dot bit-exact on {nq}x{rows}x{dim}, "
        f"max sum {int(want.max())} (2^24={1 << 24})")
    hlo = jax.jit(sq_ops.int_dot).lower(
        jnp.asarray(qc), jnp.asarray(cc)).compile().as_text()
    ops = [
        line.strip()[:240] for line in hlo.splitlines()
        if any(t in line for t in ("custom_call_target", "__triton", "cublas", " dot("))
    ]
    for line in ops[:4]:
        log("sq_exact", f"int_dot HLO: {line}")
    return {"int_dot_exact": True, "hlo": ops}


def phase_sq_score(sq, queries, data, *, rows: int) -> float:
    """SQ ``score_batch`` within the SQ tests' bound on the first ``rows``
    rows: |quantized - exact f32| <= dim * 0.1 for every pair."""
    from quantization_tpu import DistanceType, pairwise_score

    rows = min(rows, len(data))
    got = np.asarray(sq.score_batch(sq.encode_query(queries))[:, :rows])
    want = np.asarray(pairwise_score(queries, data[:rows], DistanceType.DOT, False))
    err = float(np.max(np.abs(got - want)))
    bound = data.shape[1] * 0.1
    log("sq_exact", f"score_batch max error {err:.4f} (bound {bound:.1f})")
    check(err <= bound, f"SQ score error {err} > {bound}")
    return err


def phase_bq(data, queries, gt, *, k: int, sample: int = 2048) -> dict:
    """BQ encode + top_k; XOR counts exact vs a numpy popcount."""
    from quantization_tpu import BinaryQuantizer, DistanceType, VectorParameters
    from quantization_tpu.ops import bq as bq_ops

    n, dim = data.shape
    bq = BinaryQuantizer.encode(data, VectorParameters(dim, n, DistanceType.DOT, False))
    eq = bq.encode_query(queries)
    _, ids = bq.top_k(eq, k)
    rec = recall(ids, gt)
    ms = median_ms(lambda: bq.top_k_device(eq, k))
    s = min(sample, n)
    got = np.asarray(bq.score_batch(eq))[:, :s]
    row_bytes = bq_ops.storage_bytes(dim, "u128")
    qb = bq_ops.pack_rows(queries, row_bytes)
    cb = bq_ops.pack_rows(data[:s], row_bytes)
    popcount = np.array([bin(i).count("1") for i in range(256)], np.uint8)
    xor = popcount[qb[:, None, :] ^ cb[None, :, :]].sum(axis=2, dtype=np.int32)
    want = (dim - 2 * xor).astype(np.float32)  # DOT: (d - x) - x
    check(np.array_equal(got, want), "BQ scores differ from numpy popcount")
    log("bq", f"popcount exact on {len(queries)}x{s}; recall@{k}={rec:.4f} "
        f"top_k_ms={ms:.3f}")
    return {"recall": rec, "top_k_ms": ms}


def phase_pq(data, queries, gt, *, k: int, chunk: int = PQ_CHUNK,
             sample: int = 1024) -> dict:
    """PQ encode (m = dim / chunk) + top_k; LUT scores vs a numpy sum."""
    from quantization_tpu import DistanceType, ProductQuantizer, VectorParameters

    n, dim = data.shape
    t0 = time.perf_counter()
    pq = ProductQuantizer.encode(
        data, VectorParameters(dim, n, DistanceType.DOT, False), chunk_size=chunk
    )
    log("pq", f"encode_s={time.perf_counter() - t0:.3f} m={pq.num_chunks}")
    eq = pq.encode_query(queries)
    _, ids = pq.top_k(eq, k)
    rec = recall(ids, gt)
    ms = median_ms(lambda: pq.top_k_device(eq, k))
    s = min(sample, n)
    got = np.asarray(pq.score_batch(eq))[:, :s]
    lut = np.asarray(eq.lut, np.float64)  # [Q, m, 256]
    codes = np.asarray(pq.codes)[:s, : pq.num_chunks].astype(np.int64)
    terms = lut[:, np.arange(pq.num_chunks)[None, :], codes]  # [Q, s, m]
    want = terms.sum(axis=2)
    # f32 sums of m terms in another order than float64: each partial sum
    # rounds by at most 2^-24 of the running magnitude.
    tol = pq.num_chunks * 2.0 ** -23 * np.abs(terms).sum(axis=2) + 1e-6
    err = np.abs(got - want)
    check(bool(np.all(err <= tol)),
          f"PQ LUT scores off by {float(np.max(err / tol)):.2f}x the f32 bound")
    log("pq", f"LUT scores within the f32 bound on {len(queries)}x{s}; "
        f"recall@{k}={rec:.4f} top_k_ms={ms:.3f}")
    return {"recall": rec, "top_k_ms": ms}


def phase_ivf(data, queries, gt, *, k: int,
              min_recall: float = MIN_RECALL_IVF) -> dict:
    """IVF-SQ with the auto geometry, top_k at the default nprobe."""
    from quantization_tpu import DistanceType, IVFIndex, VectorParameters

    n, dim = data.shape
    t0 = time.perf_counter()
    ivf = IVFIndex.encode(data, VectorParameters(dim, n, DistanceType.DOT, False),
                          quantizer="sq")
    m = ivf.metadata
    log("ivf", f"encode_s={time.perf_counter() - t0:.3f} nlist={m.nlist} "
        f"bucket_size={m.bucket_size} nbuckets={m.nbuckets} nprobe={m.nprobe}")
    eq = ivf.encode_query(queries)
    _, ids = ivf.top_k(eq, k)
    rec = recall(ids, gt)
    ms = median_ms(lambda: ivf.top_k_device(eq, k))
    log("ivf", f"recall@{k}={rec:.4f} (min {min_recall}) top_k_ms={ms:.3f}")
    check(rec >= min_recall, f"IVF recall {rec:.4f} < {min_recall}")
    full_s, full_i = ivf.top_k(eq, k, nscan=m.nbuckets)
    ref_s, id_score = ivf_dense_reference(ivf, eq, k)
    check(np.allclose(full_s, ref_s, rtol=1e-5, atol=1e-5),
          "IVF full-union scores differ from the dense scan")
    check(np.allclose(np.take_along_axis(id_score, full_i, axis=1), full_s,
                      rtol=1e-5, atol=1e-5),
          "IVF full-union ids do not carry their dense scores")
    log("ivf", "full-union search equals the dense scan of the inner codes")
    return {"recall": rec, "top_k_ms": ms}


def ivf_dense_reference(ivf, eq, k: int):
    """The inner quantizer's dense scan over every bucket, one score per
    original id: ``(top-k scores [Q, k], score of each id [Q, count])``,
    which an IVF search whose union is every bucket must reproduce. Pad
    slots are copies of real rows, so each id's real slot carries its
    score (non-residual indexes)."""
    import jax

    slot_ids = ivf.bucket_ids.reshape(-1)
    real = np.flatnonzero(slot_ids >= 0)
    id_score = np.empty((len(eq[0]), ivf.count), np.float32)
    id_score[:, slot_ids[real]] = np.asarray(ivf.quantizer.score_batch(eq[1]))[:, real]
    s, _ = jax.lax.top_k(id_score, k)
    return np.asarray(s), id_score


def phase_select(n: int, q: int, pools=(10, 40, 100, 1000), seed: int = 0) -> dict:
    """Informational: exact ``lax.top_k`` vs ``lax.approx_max_k`` on a
    [q, n] f32 score block, at the serving k and the two-stage pool sizes."""
    import jax
    import jax.numpy as jnp

    scores = jax.random.normal(jax.random.PRNGKey(seed), (q, n), jnp.float32)
    out = {}
    for kk in pools:
        exact = jax.jit(lambda s, kk=kk: jax.lax.top_k(s, kk))
        approx = jax.jit(lambda s, kk=kk: jax.lax.approx_max_k(s, kk))
        te, ta = median_ms(lambda: exact(scores)), median_ms(lambda: approx(scores))
        out[kk] = (te, ta)
        log("select", f"[{q}, {n}] k={kk}: top_k_ms={te:.3f} approx_max_k_ms={ta:.3f}")
    return out


def phase_four(n: int, dim: int, *, q: int, k: int, batches: int, seed: int,
               n_devices: int = 4) -> dict:
    """Sharded SQ, sharded IVF-SQ and a sharded BQ -> SQ two-stage index
    over a ``n_devices`` mesh, each served through PipelinedSearcher and
    compared with the single-card engine on the same data."""
    import jax

    from quantization_tpu import (
        BinaryQuantizer, DistanceType, PipelinedSearcher, ScalarQuantizerU8,
        TwoStageIndex, VectorParameters,
    )
    from quantization_tpu.parallel.sharded import (
        ShardedBinaryQuantizer, ShardedScalarQuantizer, make_mesh,
    )
    from quantization_tpu.parallel.sharded_ivf import ShardedIVF

    check(len(jax.devices()) >= n_devices,
          f"--four needs {n_devices} devices, found {len(jax.devices())}")
    mesh = make_mesh(n_devices)
    t0 = time.perf_counter()
    data, queries = make_corpus(n, dim, q * batches, seed)
    log("four", f"corpus {n}x{dim} made in {time.perf_counter() - t0:.1f}s")
    gt = oracle_ids(queries, data, k)
    params = VectorParameters(dim, n, DistanceType.DOT, False)

    def stream():
        for b0 in range(0, n, 65536):
            yield data[b0 : b0 + 65536]

    t0 = time.perf_counter()
    ssq = ShardedScalarQuantizer.encode(stream, params, mesh=mesh, quantile=0.99)
    sbq = ShardedBinaryQuantizer.encode(stream, params, mesh=mesh)
    sivf = ShardedIVF.encode(stream, params, mesh=mesh, quantizer="sq")
    jax.block_until_ready((ssq.codes, sbq.planes))
    log("four", f"sharded encodes {time.perf_counter() - t0:.1f}s "
        f"ivf nlist={sivf.metadata.nlist} bucket_size={sivf.metadata.bucket_size}")
    for name, arr in (("sq", ssq.codes), ("bq", sbq.planes)):
        devs = [s.device for s in arr.addressable_shards]
        check(len(set(devs)) == n_devices, f"{name} shards on {devs}")
    stats = [d.memory_stats() for d in jax.devices()[:n_devices]]
    if all(stats):  # GPUs report allocator stats; CPU devices do not
        used = [st["bytes_in_use"] for st in stats]
        log("four", f"bytes_in_use per device {used}")
        check(max(used) <= 1.25 * min(used), f"unbalanced device memory {used}")

    two = TwoStageIndex(sbq, ssq, oversampling=10.0)
    qbatches = [queries[i : i + q] for i in range(0, len(queries), q)]
    res = {}
    for name, ix, floor in (("sq", ssq, MIN_RECALL_SQ4),
                            ("ivf", sivf, MIN_RECALL_IVF4),
                            ("bq_sq", two, MIN_RECALL_BQ_SQ4)):
        searcher = PipelinedSearcher(ix, k=k, depth=4)
        out = list(searcher.search_stream(qbatches))
        ids = np.concatenate([i for _, i in out])
        rec = recall(ids, gt)
        eqb = ix.encode_query(qbatches[0])
        ms = median_ms(lambda: ix.top_k_device(eqb, k))
        log("four", f"{name}: recall@{k}={rec:.4f} (min {floor}) batch_ms={ms:.3f}")
        check(rec >= floor, f"sharded {name} recall {rec:.4f} < {floor}")
        res[name] = (np.concatenate([s for s, _ in out]), ids)

    # Single-card engines on the same data: same calibration, same codes,
    # so the same scores. Ids may swap only among tied scores.
    sq1 = ScalarQuantizerU8.encode(data, params, quantile=0.99)
    bq1 = BinaryQuantizer.encode(data, params)
    two1 = TwoStageIndex(bq1, sq1, oversampling=10.0)
    # Sharded SQ must match every row. BQ's integer scores tie in droves at
    # the candidate-pool boundary, so a tied candidate can enter one pool
    # and not the other; the two-stage result may differ on a few rows.
    for name, ix1, min_rows in (("sq", sq1, 1.0), ("bq_sq", two1, 0.98)):
        s_sh, i_sh = res[name]
        s1, i1 = ix1.top_k(ix1.encode_query(queries), k)
        rows_ok = np.all(np.isclose(s_sh, s1, rtol=1e-5, atol=1e-5), axis=1)
        # Every sharded id must score its slot's value on the single card.
        picked = np.asarray(sq1.score_candidates(sq1.encode_query(queries), i_sh))
        ids_ok = np.all(np.isclose(picked, s_sh, rtol=1e-5, atol=1e-5), axis=1)
        frac = float(np.mean(rows_ok & ids_ok))
        log("four", f"{name}: rows matching one card {frac:.4f} (min {min_rows}), "
            f"identical id slots {float(np.mean(i1 == i_sh)):.4f}")
        check(frac >= min_rows, f"sharded {name} differs from one card")
    return {"recall": {kk: recall(v[1], gt) for kk, v in res.items()}}


# ------------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded phase")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    dev = phase_device()
    if args.four:
        phase_four(N4, D4, q=Q, k=K, batches=2, seed=args.seed)
    else:
        t0 = time.perf_counter()
        data, queries = make_corpus(N, D, BATCHES * Q, args.seed)
        gt = oracle_ids(queries, data, K)
        log("data", f"corpus {N}x{D}, {len(queries)} queries, oracle in "
            f"{time.perf_counter() - t0:.1f}s")
        two = phase_sq_two_stage(data, queries, gt, q=Q, k=K)
        phase_sq_exact(nq=Q, rows=65536, dim=2 * D, seed=args.seed)
        phase_sq_score(two["sq"], queries[:Q], data, rows=65536)
        del two
        gt_q = gt[:Q]
        phase_bq(data, queries[:Q], gt_q, k=K)
        phase_pq(data, queries[:Q], gt_q, k=K)
        phase_ivf(data, queries[:Q], gt_q, k=K)
        phase_select(N, Q)
    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
