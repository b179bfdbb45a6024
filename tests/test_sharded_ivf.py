"""ShardedIVF — probe-limited search over the 8-device virtual CPU mesh.

Invariants pinned: a full union (nscan >= the bucket count) reproduces
the single-device full-probe scores exactly (bucket round-robin +
per-shard quota is a pure relayout once everything is scanned);
probe-limited recall tracks the single-device index; results carry no
duplicate ids despite the pad-bucket copies; and the four-file
checkpoint loads back into a sharded index (the sharding is a runtime
layout, not a storage property)."""

import jax
import numpy as np
import pytest

from quantization_tpu.core.types import (
    ArgumentsError,
    DistanceType,
    VectorParameters,
)
from quantization_tpu.models.ivf import IVFIndex
from quantization_tpu.parallel.sharded import make_mesh
from quantization_tpu.parallel.sharded_ivf import ShardedIVF

import _ivf_reference as ref

DIM = 32
K = 10


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 2:
        pytest.skip("needs multi-device platform")
    return make_mesh()


def clustered(rng, count, dim, clusters=16, sigma=0.15):
    centers = rng.standard_normal((clusters, dim)).astype(np.float32)
    assign = rng.integers(0, clusters, count)
    return (
        centers[assign]
        + sigma * rng.standard_normal((count, dim)).astype(np.float32)
    ).astype(np.float32)


def gt_topk(queries, data, k=K):
    s = queries @ data.T
    return np.argsort(-s, axis=1)[:, :k]


def recall(ids, gt):
    ids = np.asarray(ids)
    return np.mean(
        [len(set(ids[r]) & set(gt[r])) / gt.shape[1] for r in range(len(gt))]
    )


@pytest.mark.parametrize("kind", ["sq", "pq", "bq"])
def test_full_union_matches_single_device(rng, mesh, kind):
    # nscan >= nbuckets scans every bucket on both layouts: top-k score
    # VALUES must match the single-device index exactly (ids may permute
    # within ties).
    count = 700
    data = clustered(rng, count, DIM)
    queries = clustered(rng, 8, DIM)
    params = VectorParameters(DIM, count, DistanceType.DOT, False)
    kw = {"chunk_size": 2} if kind == "pq" else {}
    ivf = IVFIndex.encode(
        data, params, quantizer=kind, nlist=10, bucket_size=64, nprobe=10,
        **kw,
    )
    sharded = ShardedIVF(ivf, mesh)
    eq = ivf.encode_query(queries)
    sv1, _ = ivf.top_k(eq, K, nprobe=10**9, nscan=10**9)
    sv2, ids2 = sharded.top_k(eq, K, nprobe=10**9, nscan=10**9)
    np.testing.assert_allclose(sv2, sv1, rtol=1e-5, atol=1e-4)
    for row in ids2:
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)  # no dup ids


def test_probe_limited_recall_tracks_single_device(rng, mesh):
    count = 2000
    data = clustered(rng, count, DIM, clusters=32)
    queries = clustered(rng, 16, DIM, clusters=32)
    params = VectorParameters(DIM, count, DistanceType.DOT, False)
    ivf = IVFIndex.encode(
        data, params, quantizer="sq", nlist=32, bucket_size=64, nprobe=8
    )
    sharded = ShardedIVF(ivf, mesh)
    gt = gt_topk(queries, data)
    eq = ivf.encode_query(queries)
    # The per-shard quota scans ceil(nscan/n_shards) buckets per shard —
    # a (different, at least as wide) union vs single-device: recall must
    # land in the same regime, and widen monotonically.
    r1 = recall(ivf.top_k(eq, K, nscan=32)[1], gt)
    r_narrow = recall(sharded.top_k(eq, K, nscan=32)[1], gt)
    r_wide = recall(sharded.top_k(eq, K, nscan=10**9)[1], gt)
    assert r_wide >= r_narrow
    assert r_narrow >= r1 - 0.15
    assert r_wide > 0.8


def test_methods_and_arguments(rng, mesh):
    count = 512
    data = clustered(rng, count, DIM)
    queries = clustered(rng, 4, DIM)
    params = VectorParameters(DIM, count, DistanceType.L2, True)
    ivf = IVFIndex.encode(
        data, params, quantizer="sq", nlist=8, bucket_size=64, nprobe=8
    )
    sharded = ShardedIVF(ivf, mesh)
    eq = ivf.encode_query(queries)
    sv_e, _ = sharded.top_k(eq, K, method="exact")
    sv_a, _ = sharded.top_k(eq, K, method="approx")
    # Inverted L2: all real scores negative; approx stays in value range.
    assert np.all(sv_e[sv_e > -1e38] <= 1e-3)
    assert sv_a.shape == sv_e.shape
    with pytest.raises(ArgumentsError):
        sharded.top_k(eq, K, nprobe=-1)


def _sharded_reference(sharded, queries, eq, sv, ids, *, nprobe=None,
                       nscan=None):
    """Sharded ``top_k`` vs the numpy dense reference over the buckets
    every shard's quota selects (tests/_ivf_reference.py), read from the
    sharded arrays in their round-robin layout."""
    meta = sharded.metadata
    nb = meta.nbuckets
    p = min(int(nprobe or meta.nprobe), nb)
    u = max(min(int(nscan) if nscan else 4 * p, nb), p)
    u_loc = min(-(-u // sharded.n_shards), sharded._b_loc)
    b_loc = sharded._b_loc
    from quantization_tpu.models.ivf import _bucket_priority

    prio = np.asarray(_bucket_priority(
        jax.numpy.asarray(queries), sharded._means_dev,
        sharded.params.distance_type, sharded.params.invert, p,
    ))
    buckets = np.concatenate([
        sh * b_loc + np.argsort(-prio[sh * b_loc:(sh + 1) * b_loc],
                                kind="stable")[:u_loc]
        for sh in range(sharded.n_shards)
    ])
    q_eq = eq[1]
    kind = meta.kind
    inner = tuple(np.asarray(a) for a in sharded._inner)
    if kind == "sq":
        eq_arrays = (q_eq.codes, q_eq.offsets)
        mult = q_eq.mult if meta.residual else sharded._mult_dev
        inner = inner + (np.asarray(mult),)
    elif kind == "bq":
        eq_arrays = (
            (q_eq.codes, q_eq.mult, q_eq.qb) if meta.residual
            else (q_eq.planes,)
        )
    else:
        eq_arrays = (q_eq.lut,)
        if meta.residual:
            inner = inner + (np.asarray(sharded._rowadd_dev),)
    top, by_id = ref.reference_topk(
        kind, queries, eq_arrays, inner, np.asarray(sharded._slot_ids_dev),
        buckets, meta.bucket_size, K, dim=sharded.params.dim,
        dt=sharded.params.distance_type, invert=sharded.params.invert,
        means=np.asarray(sharded._means_dev),
        corr_scale=(
            float(sharded._corr_scale_dev) if meta.residual else None
        ),
    )
    ref.assert_matches_reference(sv, ids, top, by_id)


@pytest.mark.parametrize("kind,method", [("sq", "exact"), ("sq", "approx"),
                                          ("bq", "approx")])
def test_sharded_indexed_scan_matches_compact(rng, mesh, kind, method):
    # The per-shard compact scan equals the dense reference over the
    # buckets each shard's quota selects; scan="auto" is the same scan,
    # and the removed in-place scan (scan="indexed") raises.
    count = 8 * 512
    data = clustered(rng, count, DIM, clusters=8, sigma=0.08)
    queries = clustered(rng, 8, DIM, clusters=8, sigma=0.08)
    params = VectorParameters(DIM, count, DistanceType.DOT, False)
    sharded = ShardedIVF.encode(
        data, params, mesh=mesh, quantizer=kind, nlist=8, bucket_size=512,
        nprobe=4,
    )
    eq = sharded.encode_query(queries)
    a_s, a_i = sharded.top_k(eq, K, method=method, scan="auto")
    c_s, c_i = sharded.top_k(eq, K, method=method, scan="compact")
    np.testing.assert_array_equal(a_s, c_s)
    np.testing.assert_array_equal(a_i, c_i)
    _sharded_reference(sharded, queries, eq, c_s, c_i)
    with pytest.raises(ArgumentsError, match="ROADMAP"):
        sharded.top_k(eq, K, method=method, scan="indexed")


def test_fully_distributed_two_stage(rng, mesh):
    # ShardedIVF coarse -> ShardedExactRescorer fine: the whole serving
    # ladder distributed — probe-limited sharded scan feeds a sharded
    # f32 rescore, no single-device stage anywhere.
    from quantization_tpu.models.pipeline import TwoStageIndex
    from quantization_tpu.parallel.sharded import ShardedExactRescorer

    count = 2000
    data = clustered(rng, count, DIM, clusters=32)
    queries = clustered(rng, 16, DIM, clusters=32)
    params = VectorParameters(DIM, count, DistanceType.DOT, False)
    sivf = ShardedIVF.encode(
        data, params, mesh=mesh, quantizer="sq", nlist=32, bucket_size=64,
        nprobe=8, nscan=64,
    )
    two = TwoStageIndex(
        sivf,
        ShardedExactRescorer(data, params.distance_type, params.invert,
                             mesh),
        oversampling=8.0,
    )
    s, ids = two.top_k(two.encode_query(queries), K)
    gt = gt_topk(queries, data)
    assert recall(ids, gt) > 0.8


def test_save_load_roundtrip(rng, mesh, tmp_path):
    count = 600
    data = clustered(rng, count, DIM)
    queries = clustered(rng, 8, DIM)
    params = VectorParameters(DIM, count, DistanceType.DOT, False)
    sharded = ShardedIVF.encode(
        data, params, mesh=mesh, quantizer="sq", nlist=8, bucket_size=64,
        nprobe=8,
    )
    dp, mp = tmp_path / "ivf.data", tmp_path / "ivf.meta"
    sharded.save(dp, mp)
    back = ShardedIVF.load(dp, mp, params, mesh=mesh)
    eq = sharded.encode_query(queries)
    sv1, ids1 = sharded.top_k(eq, K, nscan=10**9)
    sv2, ids2 = back.top_k(back.encode_query(queries), K, nscan=10**9)
    np.testing.assert_allclose(sv2, sv1, rtol=1e-6)
    np.testing.assert_array_equal(ids1, ids2)


@pytest.mark.parametrize("kind", ["sq", "pq", "bq"])
def test_streaming_build_and_interop_with_single_device(
    rng, mesh, kind, tmp_path
):
    # Sharded-NATIVE build: a one-shot stream factory (never a
    # materialized array inside the class), codes land straight in
    # per-shard buffers, and the four-file checkpoint is bidirectional
    # with the single-device IVFIndex (same bytes semantics).
    count = 1500
    data = clustered(rng, count, DIM, clusters=12)
    queries = clustered(rng, 8, DIM, clusters=12)
    params = VectorParameters(DIM, count, DistanceType.DOT, False)
    kw = {"chunk_size": 2} if kind == "pq" else {}

    def stream():
        for s0 in range(0, count, 256):
            yield data[s0 : s0 + 256]

    sharded = ShardedIVF.encode(
        stream, params, mesh=mesh, quantizer=kind, nlist=12,
        bucket_size=64, nprobe=12, **kw,
    )
    # No device holds more than its bucket share of code rows.
    ns = sharded.n_shards
    b_loc = -(-sharded.metadata.nbuckets // ns)
    axis_dim = 1 if kind == "bq" else 0
    for shard in sharded._inner[0].addressable_shards:
        assert shard.data.shape[axis_dim] <= b_loc * 64
    # Search quality. SQ/PQ: full union ~= f32 ground truth. BQ: sign
    # codes cannot rank WITHIN a tight cluster (every member shares the
    # code), so f32-GT recall is structurally ~K/cluster_size there —
    # pin instead that the full union returns EXACTLY the top-K of an
    # independent numpy Hamming oracle over the packed corpus.
    eq = sharded.encode_query(queries)
    sv, ids = sharded.top_k(eq, K, nscan=10**9)
    if kind == "bq":
        from quantization_tpu.ops import bq as bq_ops

        rb = bq_ops.storage_bytes(DIM)
        packs = np.unpackbits(
            bq_ops.pack_rows(data, rb), axis=1, bitorder="little"
        ).astype(np.int32)
        qpacks = np.unpackbits(
            bq_ops.pack_rows(queries, rb), axis=1, bitorder="little"
        ).astype(np.int32)
        ham = (qpacks[:, None, :] != packs[None, :, :]).sum(axis=2)
        scores = DIM - 2.0 * ham  # DOT mapping, encoded_vectors_binary.rs
        oracle = -np.sort(-scores, axis=1)[:, :K]
        np.testing.assert_array_equal(np.sort(sv, axis=1)[:, ::-1], oracle)
    else:
        gt = gt_topk(queries, data)
        assert recall(ids, gt) > 0.8
    for row in ids:
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)
    # Sharded save -> single-device load: identical full-union values.
    dp, mp = tmp_path / "ivf.data", tmp_path / "ivf.meta"
    sharded.save(dp, mp)
    single = IVFIndex.load(dp, mp, params)
    sv1, ids1 = single.top_k(single.encode_query(queries), K, nscan=10**9)
    np.testing.assert_allclose(sv1, sv, rtol=1e-5, atol=1e-4)
    # Single-device save -> per-shard sharded load: identical again.
    dp2, mp2 = tmp_path / "ivf2.data", tmp_path / "ivf2.meta"
    single.save(dp2, mp2)
    back = ShardedIVF.load(dp2, mp2, params, mesh=mesh)
    sv2, ids2 = back.top_k(back.encode_query(queries), K, nscan=10**9)
    np.testing.assert_allclose(sv2, sv, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kind", ["sq", "pq", "bq"])
def test_residual_streaming_build_and_load(rng, mesh, kind, tmp_path):
    # Residual sharded-native build: means/calibration/codes all from the
    # stream; the per-shard load re-derives the residual row terms on
    # device and reproduces the builder's scores exactly. Residual-BQ is
    # DOT-only (models/ivf.py encode gate) and carries beta = E|r_i| in
    # the metadata sidecar instead of derived row terms.
    count = 3000
    centers = rng.standard_normal((6, DIM)).astype(np.float32) * 3
    assign = rng.integers(0, 6, count)
    data = (
        centers[assign]
        + 0.3 * rng.standard_normal((count, DIM)).astype(np.float32)
    ).astype(np.float32)
    queries = data[rng.choice(count, 8, replace=False)].astype(np.float32)
    params = VectorParameters(
        DIM, count,
        DistanceType.DOT if kind == "bq" else DistanceType.L2,
        kind != "bq",
    )
    kw = {"chunk_size": 2} if kind == "pq" else {}

    def stream():
        for s0 in range(0, count, 512):
            yield data[s0 : s0 + 512]

    sharded = ShardedIVF.encode(
        stream, params, mesh=mesh, quantizer=kind, nlist=6,
        bucket_size=512, nprobe=6, residual=True, **kw,
    )
    eq = sharded.encode_query(queries)
    sv, ids = sharded.top_k(eq, K, nscan=10**9)
    if kind == "bq":
        # beta from the full encode stream, persisted in the sidecar.
        assert sharded.metadata.residual_scale > 0
    else:
        # L2-invert near-duplicate queries: the query must rank top-1
        # (1-bit residual signs tie within a bucket, so not for BQ).
        qid = np.asarray(
            [np.flatnonzero((data == q).all(axis=1))[0] for q in queries]
        )
        assert np.all(ids[:, 0] == qid)
    dp, mp = tmp_path / "rivf.data", tmp_path / "rivf.meta"
    sharded.save(dp, mp)
    back = ShardedIVF.load(dp, mp, params, mesh=mesh)
    assert back.metadata.residual_scale == sharded.metadata.residual_scale
    sv2, ids2 = back.top_k(back.encode_query(queries), K, nscan=10**9)
    np.testing.assert_allclose(sv2, sv, rtol=1e-4, atol=1e-3)
    # ... and the single-device loader agrees on the same files.
    single = IVFIndex.load(dp, mp, params)
    sv3, _ = single.top_k(single.encode_query(queries), K, nscan=10**9)
    np.testing.assert_allclose(sv3, sv, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("kind", ["sq", "pq", "bq"])
def test_residual_full_union_matches_single_device(rng, mesh, kind):
    # Residual indexes on the mesh: the per-shard scan applies the same
    # additive corrections (corr from the shard's slice of q.c_b, rowadd
    # bucket-sharded) as the single-device path — full union must match
    # score values exactly.
    count = 3000
    centers = rng.standard_normal((6, DIM)).astype(np.float32) * 3
    assign = rng.integers(0, 6, count)
    data = (
        centers[assign]
        + 0.3 * rng.standard_normal((count, DIM)).astype(np.float32)
    ).astype(np.float32)
    queries = data[rng.choice(count, 8, replace=False)].astype(np.float32)
    params = VectorParameters(
        DIM, count,
        DistanceType.DOT if kind == "bq" else DistanceType.L2,
        kind != "bq",
    )
    kw = {"chunk_size": 2} if kind == "pq" else {}
    ivf = IVFIndex.encode(
        data, params, quantizer=kind, nlist=6, bucket_size=512,
        nprobe=6, residual=True, **kw,
    )
    sharded = ShardedIVF(ivf, mesh)
    eq = ivf.encode_query(queries)
    sv1, _ = ivf.top_k(eq, K, nprobe=10**9, nscan=10**9)
    sv2, ids2 = sharded.top_k(eq, K, nprobe=10**9, nscan=10**9)
    np.testing.assert_allclose(sv2, sv1, rtol=1e-4, atol=1e-3)
    for row in ids2:
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)
    # Probe-limited residual search stays sane (near-duplicate queries:
    # the right bucket is the top probe).
    sv3, ids3 = sharded.top_k(eq, K, nprobe=2)
    assert np.all(ids3 >= 0)


def test_residual_sharded_indexed_scan(rng, mesh):
    # Residual corrections on the per-shard scan equal the dense numpy
    # reference of the dot-expansion; scan="indexed" raises.
    count = 3000
    centers = rng.standard_normal((6, DIM)).astype(np.float32) * 3
    assign = rng.integers(0, 6, count)
    data = (
        centers[assign]
        + 0.3 * rng.standard_normal((count, DIM)).astype(np.float32)
    ).astype(np.float32)
    queries = data[rng.choice(count, 8, replace=False)].astype(np.float32)
    params = VectorParameters(DIM, count, DistanceType.L2, True)
    sharded = ShardedIVF.encode(
        data, params, mesh=mesh, quantizer="sq", nlist=6,
        bucket_size=512, nprobe=4, residual=True,
    )
    eq = sharded.encode_query(queries)
    sv, ids = sharded.top_k(eq, K)
    _sharded_reference(sharded, queries, eq, sv, ids)
    with pytest.raises(ArgumentsError, match="ROADMAP"):
        sharded.top_k(eq, K, scan="indexed")
