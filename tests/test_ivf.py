"""IVF index tests — ops/ivf.py bucket construction + models/ivf.py search.

No reference counterpart (qdrant/quantization is full-scan only); the
invariants pinned here are the ones that make IVF trustworthy as a serving
index: bucket bookkeeping is a permutation, full-probe search scores every
vector exactly once (score-value parity with the plain full-scan class),
probe-limited recall degrades gracefully and monotonically, and the
four-file checkpoint round-trips."""

import jax.numpy as jnp
import numpy as np
import pytest

from quantization_tpu.core.distances import pairwise_score
from quantization_tpu.core.types import (
    ArgumentsError,
    DistanceType,
    StoppedError,
    VectorParameters,
)
from quantization_tpu.models.ivf import IVFIndex
from quantization_tpu.models.pipeline import ExactRescorer, TwoStageIndex
from quantization_tpu.models.sq import ScalarQuantizerU8
from quantization_tpu.ops import ivf as ivf_ops

import _ivf_reference as ref

DIM = 32
K = 10


def clustered(rng, count, dim, clusters=16, sigma=0.15):
    centers = rng.standard_normal((clusters, dim)).astype(np.float32)
    assign = rng.integers(0, clusters, count)
    return (
        centers[assign]
        + sigma * rng.standard_normal((count, dim)).astype(np.float32)
    ).astype(np.float32)


def gt_topk(queries, data, dt, invert, k=K):
    s = np.asarray(pairwise_score(queries, data, dt, invert))
    return np.argsort(-s, axis=1)[:, :k]


def recall(ids, gt):
    ids = np.asarray(ids)
    return np.mean(
        [len(set(ids[r]) & set(gt[r])) / gt.shape[1] for r in range(len(gt))]
    )


# ------------------------------------------------------------------ ops


def test_build_buckets_is_an_aligned_permutation(rng):
    assign = rng.integers(0, 7, 500).astype(np.int32)
    perm, ids = ivf_ops.build_buckets(assign, 64)
    nb, s = ids.shape
    assert perm.shape == (nb * s,)
    # Every original id appears in exactly one REAL slot.
    flat = ids.reshape(-1)
    real = flat[flat >= 0]
    assert sorted(real.tolist()) == list(range(500))
    # Slot (b, s): perm matches the id when real; pad slots follow the
    # GLOBAL cyclic cursor (bucket order), so the mapping is derivable
    # from bucket_ids + N alone; real members of a bucket share one
    # cluster.
    cursor = 0
    for b in range(nb):
        members = set(ids[b][ids[b] >= 0].tolist())
        assert len(set(assign[list(members)].tolist())) == 1
        for sl in range(s):
            row = perm[b * s + sl]
            if ids[b, sl] >= 0:
                assert row == ids[b, sl]
            else:
                assert row == cursor % 500
                cursor += 1
    # No original id occupies more than two slots (dedupe margin bound).
    counts = np.bincount(perm, minlength=500)
    assert counts.max() <= 2


def test_bucket_means_match_naive(rng):
    data = rng.standard_normal((300, DIM)).astype(np.float32)
    assign = rng.integers(0, 5, 300).astype(np.int32)
    perm, ids = ivf_ops.build_buckets(assign, 32)
    means = ivf_ops.bucket_means(data, perm, ids, block_buckets=3)
    for b in range(ids.shape[0]):
        members = ids[b][ids[b] >= 0]
        np.testing.assert_allclose(
            means[b], data[members].mean(axis=0), rtol=1e-5, atol=1e-5
        )


def test_assign_clusters_is_nearest(rng):
    data = rng.standard_normal((200, DIM)).astype(np.float32)
    centers = rng.standard_normal((9, DIM)).astype(np.float32)
    got = ivf_ops.assign_clusters(data, centers)
    want = np.argmin(
        ((data[:, None, :] - centers[None, :, :]) ** 2).sum(-1), axis=1
    )
    np.testing.assert_array_equal(got, want)


def test_assign_clusters_center_blocked(rng, monkeypatch):
    # Force the center axis to split into several blocks (the capacity-
    # geometry path, nlist ~ 32k): the running-min scan must reproduce
    # the single-block argmin exactly, pad centers never winning.
    data = rng.standard_normal((300, DIM)).astype(np.float32)
    centers = rng.standard_normal((300, DIM)).astype(np.float32)
    want = ivf_ops.assign_clusters(data, centers)
    monkeypatch.setattr(ivf_ops, "ASSIGN_BLOCK", 64)
    monkeypatch.setattr(ivf_ops, "_SCORES_BYTES_CAP", 64 * 128 * 4)
    ncb, cb = ivf_ops._center_blocks(300)
    assert ncb > 1
    got = ivf_ops.assign_clusters(data, centers)
    np.testing.assert_array_equal(got, want)


def test_sample_cap_scales_with_nlist():
    # VERDICT r4 #1: the old flat 262k cap degraded nlist ~ 32k training
    # to ~8 rows/center. The cap must guarantee the per-center budget up
    # to the (much larger) streamed-trainer bound.
    per = ivf_ops.IVF_SAMPLE_PER_CENTER
    assert ivf_ops.sample_cap(4096) == ivf_ops.IVF_SAMPLE_CAP
    big = ivf_ops.sample_cap(32_552)
    assert big == ivf_ops.IVF_SAMPLE_CAP_BIG
    assert big >= per * 32_552  # >= 64 rows/center at the 100M geometry


def test_train_centers_streamed_matches_incore_quality(rng, monkeypatch):
    # Route a small clustered problem through the STREAMED blocked-Lloyd
    # trainer (capacity path) by shrinking the score cap; its centers
    # must recover the true clusters as well as the in-core trainer:
    # compare mean squared assignment distance (the k-means objective).
    data = clustered(rng, 4000, DIM, clusters=12, sigma=0.1)

    def objective(centers):
        a = ivf_ops.assign_clusters(data, centers)
        return float(np.mean(np.sum((data - centers[a]) ** 2, axis=1)))

    incore = ivf_ops.train_centers(data, 12, seed=3)
    monkeypatch.setattr(ivf_ops, "_SCORES_BYTES_CAP", 1 << 16)
    monkeypatch.setattr(ivf_ops, "ASSIGN_BLOCK", 512)
    streamed = ivf_ops.train_centers(data, 12, seed=3)
    assert streamed.shape == incore.shape
    assert objective(streamed) <= objective(incore) * 1.1


def test_train_centers_streamed_cancellation(rng, monkeypatch):
    from quantization_tpu.core.types import StoppedError

    data = clustered(rng, 2000, DIM, clusters=8)
    monkeypatch.setattr(ivf_ops, "_SCORES_BYTES_CAP", 1 << 16)
    with pytest.raises(StoppedError):
        ivf_ops.train_centers(data, 8, stop_condition=lambda: True)


# ---------------------------------------------------------------- search


@pytest.mark.parametrize(
    "dt,invert",
    [(DistanceType.DOT, False), (DistanceType.L2, True)],
)
def test_full_probe_matches_full_scan(rng, dt, invert):
    # Probing every bucket must reproduce the plain full-scan class's
    # top-k SCORES exactly (same codes, reordered corpus; ids may permute
    # within ties, values may not).
    count = 700
    data = clustered(rng, count, DIM)
    queries = clustered(rng, 8, DIM)
    params = VectorParameters(DIM, count, dt, invert)
    ivf = IVFIndex.encode(
        data, params, quantizer="sq", nlist=10, bucket_size=64, nprobe=10**9
    )
    plain = ScalarQuantizerU8.encode(data, params)
    sv, ids = ivf.top_k(ivf.encode_query(queries), K)
    pv, _ = plain.top_k(plain.encode_query(queries), K)
    np.testing.assert_allclose(sv, np.asarray(pv), rtol=1e-5, atol=1e-4)
    assert np.all(np.asarray(ids) >= 0)


def test_probe_limited_recall_monotonic(rng):
    count = 2000
    data = clustered(rng, count, DIM, clusters=32)
    queries = clustered(rng, 16, DIM, clusters=32)
    params = VectorParameters(DIM, count, DistanceType.DOT, False)
    ivf = IVFIndex.encode(
        data, params, quantizer="sq", nlist=32, bucket_size=64, nprobe=4
    )
    gt = gt_topk(queries, data, DistanceType.DOT, False)
    eq = ivf.encode_query(queries)
    r_all = recall(ivf.top_k(eq, K, nprobe=10**9)[1], gt)
    r_8 = recall(ivf.top_k(eq, K, nprobe=8)[1], gt)
    r_2 = recall(ivf.top_k(eq, K, nprobe=2)[1], gt)
    assert r_all >= r_8 >= r_2
    assert r_all > 0.8  # full probe == full scan recall
    assert r_8 > 0.5  # clustered data: few probes already recover most


def test_ivf_pq_and_bq_inner(rng):
    count = 600
    data = clustered(rng, count, DIM)
    queries = clustered(rng, 8, DIM)
    params = VectorParameters(DIM, count, DistanceType.DOT, False)
    gt = gt_topk(queries, data, DistanceType.DOT, False)
    pq = IVFIndex.encode(
        data, params, quantizer="pq", nlist=8, bucket_size=64,
        nprobe=8, chunk_size=2,
    )
    r = recall(pq.top_k(pq.encode_query(queries), K)[1], gt)
    assert r > 0.5
    bq = IVFIndex.encode(
        data, params, quantizer="bq", nlist=8, bucket_size=64, nprobe=8
    )
    sv, ids = bq.top_k(bq.encode_query(queries), K)
    assert np.asarray(ids).shape == (8, K)
    assert np.all(np.asarray(ids) >= 0)


def test_ivf_opq_rotation_passthrough(rng):
    count = 400
    data = clustered(rng, count, DIM)
    params = VectorParameters(DIM, count, DistanceType.DOT, False)
    ivf = IVFIndex.encode(
        data, params, quantizer="pq", nlist=4, bucket_size=128,
        nprobe=10**9, chunk_size=2, rotation="opq",
    )
    assert ivf.quantizer.metadata.rotation is not None
    queries = clustered(rng, 8, DIM)
    gt = gt_topk(queries, data, DistanceType.DOT, False)
    r = recall(ivf.top_k(ivf.encode_query(queries), K)[1], gt)
    assert r > 0.5  # full probe: recall is the (O)PQ code's own


def test_save_load_roundtrip(rng, tmp_path):
    count = 500
    data = clustered(rng, count, DIM)
    queries = clustered(rng, 8, DIM)
    params = VectorParameters(DIM, count, DistanceType.L2, True)
    ivf = IVFIndex.encode(
        data, params, quantizer="sq", nlist=8, bucket_size=64, nprobe=4
    )
    ivf.save(tmp_path / "d.bin", tmp_path / "m.json")
    back = IVFIndex.load(tmp_path / "d.bin", tmp_path / "m.json", params)
    assert back.metadata.kind == "sq"
    a_s, a_i = ivf.top_k(ivf.encode_query(queries), K)
    b_s, b_i = back.top_k(back.encode_query(queries), K)
    np.testing.assert_allclose(np.asarray(a_s), np.asarray(b_s), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(a_i), np.asarray(b_i))


def test_ivf_as_two_stage_coarse(rng):
    count = 1500
    data = clustered(rng, count, DIM, clusters=24)
    queries = clustered(rng, 16, DIM, clusters=24)
    params = VectorParameters(DIM, count, DistanceType.DOT, False)
    gt = gt_topk(queries, data, DistanceType.DOT, False)
    ivf = IVFIndex.encode(
        data, params, quantizer="pq", nlist=24, bucket_size=64,
        nprobe=8, chunk_size=8,
    )
    two = TwoStageIndex(
        ivf, ExactRescorer(data, DistanceType.DOT, False), oversampling=8
    )
    eq = two.encode_query(queries)
    r2 = recall(two.top_k(eq, K)[1], gt)
    r1 = recall(ivf.top_k(ivf.encode_query(queries), K)[1], gt)
    assert r2 >= r1  # rescoring can only help on the probed pool
    assert r2 > 0.6


def test_argument_errors(rng):
    data = clustered(rng, 300, DIM)
    params = VectorParameters(DIM, 300, DistanceType.DOT, False)
    with pytest.raises(ArgumentsError):
        IVFIndex.encode(data, params, quantizer="nope")
    with pytest.raises(ArgumentsError):
        IVFIndex.encode(data[:10], params, quantizer="sq")
    with pytest.raises(ArgumentsError):
        IVFIndex.encode(
            data, params, quantizer="sq", nlist=0
        )
    with pytest.raises(ArgumentsError):
        IVFIndex.encode(lambda: iter(()), params, quantizer="sq")
    ivf = IVFIndex.encode(
        data, params, quantizer="sq", nlist=4, bucket_size=64
    )
    with pytest.raises(ArgumentsError):
        ivf.encode_query(np.zeros((2, DIM + 1), np.float32))


def test_stop_condition(rng):
    data = clustered(rng, 400, DIM)
    params = VectorParameters(DIM, 400, DistanceType.DOT, False)
    with pytest.raises(StoppedError):
        IVFIndex.encode(
            data, params, quantizer="sq", nlist=4,
            stop_condition=lambda: True,
        )


# -------------------------------------------------------------- residual


def res_corpus(rng, count, dim, queries=8):
    """Strongly clustered corpus (the residual regime: per-bucket spread
    well below the data scale) + near-duplicate queries."""
    centers = rng.standard_normal((6, dim)).astype(np.float32) * 3
    assign = rng.integers(0, 6, count)
    data = (
        centers[assign]
        + 0.3 * rng.standard_normal((count, dim)).astype(np.float32)
    ).astype(np.float32)
    qs = data[rng.choice(count, queries, replace=False)]
    qs = qs + 0.05 * rng.standard_normal(qs.shape).astype(np.float32)
    return data, qs.astype(np.float32)


def _res_pair(rng, kind, dt, invert, count=3000, nlist=6):
    data, queries = res_corpus(rng, count, DIM)
    params = VectorParameters(DIM, count, dt, invert)
    kw = {"chunk_size": 2} if kind == "pq" else {}
    out = {}
    for residual in (False, True):
        out[residual] = IVFIndex.encode(
            data, params, quantizer=kind, nlist=nlist, bucket_size=512,
            nprobe=nlist, residual=residual, seed=0, **kw,
        )
    return data, queries, params, out


@pytest.mark.parametrize(
    "kind,dt,invert",
    [
        ("sq", DistanceType.DOT, False),
        ("sq", DistanceType.DOT, True),
        ("sq", DistanceType.L2, False),
        ("sq", DistanceType.L2, True),
        ("pq", DistanceType.DOT, False),
        ("pq", DistanceType.L2, True),
    ],
)
def test_residual_cuts_score_error(rng, kind, dt, invert):
    # residual=True re-spends the inner code budget on v - bucket_center:
    # on clustered data the returned scores must approximate the exact
    # metric MUCH better than plain inner codes, without losing recall.
    # Mean (not max) error: the max is dominated by points whose coarse
    # cell merged two true clusters (their residuals sit at data scale
    # regardless of codec), a property of the coarse k-means, not of
    # residual coding.
    data, queries, params, idx = _res_pair(rng, kind, dt, invert)
    gt_s = np.asarray(pairwise_score(queries, data, dt, invert))
    gt = np.argsort(-gt_s, axis=1)[:, :K]
    res = {}
    for residual, ivf in idx.items():
        sv, ids = ivf.top_k(
            ivf.encode_query(queries), K, method="exact",
            nscan=ivf.metadata.nbuckets,
        )
        assert (ids >= 0).all()
        assert all(len(set(r.tolist())) == K for r in ids)
        err = np.mean(np.abs(sv - np.take_along_axis(gt_s, ids, axis=1)))
        res[residual] = (recall(ids, gt), err)
    assert res[True][1] <= res[False][1] * 0.7, res
    assert res[True][0] >= res[False][0] - 0.02, res


def test_residual_save_load_roundtrip(rng, tmp_path):
    # Nothing residual-specific is persisted beyond the metadata flag:
    # the effective search arrays (decoded row norms, corr scale) are
    # re-derived from codes + means at load and must reproduce scores
    # exactly.
    for kind in ("sq", "pq"):
        data, queries, params, idx = _res_pair(
            rng, kind, DistanceType.L2, True, count=2000, nlist=4
        )
        ivf = idx[True]
        ivf.save(tmp_path / f"{kind}.bin", tmp_path / f"{kind}.json")
        back = IVFIndex.load(
            tmp_path / f"{kind}.bin", tmp_path / f"{kind}.json", params
        )
        assert back.metadata.residual
        a_s, a_i = ivf.top_k(ivf.encode_query(queries), K)
        b_s, b_i = back.top_k(back.encode_query(queries), K)
        np.testing.assert_allclose(
            np.asarray(a_s), np.asarray(b_s), rtol=1e-5, atol=1e-5
        )
        np.testing.assert_array_equal(np.asarray(a_i), np.asarray(b_i))


def test_residual_argument_errors(rng):
    data, _ = res_corpus(rng, 1500, DIM)
    mk = lambda dt, inv: VectorParameters(DIM, 1500, dt, inv)  # noqa: E731
    with pytest.raises(ArgumentsError):  # BQ L2: no per-slot |v|^2 carrier
        IVFIndex.encode(
            data, mk(DistanceType.L2, False), quantizer="bq",
            nlist=2, bucket_size=512, residual=True,
        )
    with pytest.raises(ArgumentsError):  # L1 has no dot-expansion
        IVFIndex.encode(
            data, mk(DistanceType.L1, True), quantizer="sq",
            nlist=2, bucket_size=512, residual=True,
        )
    with pytest.raises(ArgumentsError):  # bucket % RESIDUAL_ALIGN
        IVFIndex.encode(
            data, mk(DistanceType.DOT, False), quantizer="sq",
            nlist=2, bucket_size=256, residual=True,
        )


@pytest.mark.parametrize("invert", [False, True])
def test_residual_bq_lifts_recall(rng, invert):
    # Residual-BQ (DOT only): 1-bit signs of v - bucket_center scored
    # against the query's quantized VALUES (asymmetric), plus the f32
    # bucket term. On clustered data the raw sign bits are nearly
    # constant within a cluster (plain BQ recall collapses); residual
    # signs carry the within-cluster ranking signal — recall must rise
    # decisively, and the returned scores must be in DATA units
    # (approximately the exact metric), unlike plain BQ's Hamming units.
    data, queries, params, idx = _res_pair(
        rng, "bq", DistanceType.DOT, invert, count=3000, nlist=6
    )
    gt_s = np.asarray(
        pairwise_score(queries, data, DistanceType.DOT, invert)
    )
    gt = np.argsort(-gt_s, axis=1)[:, :K]
    rec = {}
    for residual, ivf in idx.items():
        assert ivf.metadata.residual is residual
        sv, ids = ivf.top_k(
            ivf.encode_query(queries), K, method="exact",
            nscan=ivf.metadata.nbuckets,
        )
        rec[residual] = recall(ids, gt)
        if residual:
            assert ivf.metadata.residual_scale > 0
            # Scores approximate the exact metric at 1-bit resolution:
            # the estimator's noise is ~beta*|q|*sqrt(d), far below the
            # data-scale spread of this fixture's clusters.
            err = np.mean(
                np.abs(
                    np.asarray(sv)
                    - np.take_along_axis(
                        gt_s, np.asarray(ids), axis=1
                    )
                )
            )
            spread = np.mean(np.ptp(gt_s, axis=1))
            assert err < 0.25 * spread, (err, spread)
    assert rec[True] >= rec[False] + 0.1, rec


def test_residual_bq_normalized_corpus_warns(rng):
    # Measured serving knowledge as a runtime guard (VERDICT r4 #8): on a
    # unit-normalized corpus residual-BQ loses recall vs plain signs
    # (BASELINE "Residual-BQ at 10M"), so the build must warn. The
    # unnormalized regime (where residual-BQ measurably wins) must NOT.
    import warnings

    data, _ = res_corpus(rng, 1500, DIM)
    params = VectorParameters(DIM, 1500, DistanceType.DOT, False)
    with pytest.warns(UserWarning, match="unit-normalized"):
        IVFIndex.encode(
            data / np.linalg.norm(data, axis=1, keepdims=True),
            params, quantizer="bq", nlist=2, bucket_size=512,
            residual=True,
        )
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # any warning -> test failure
        IVFIndex.encode(
            data, params, quantizer="bq", nlist=2, bucket_size=512,
            residual=True,
        )
        # Normalized but residual=False: plain IVF-BQ is the documented
        # capacity configuration — no warning either.
        IVFIndex.encode(
            data / np.linalg.norm(data, axis=1, keepdims=True),
            params, quantizer="bq", nlist=2, bucket_size=512,
        )


def test_residual_bq_save_load_roundtrip(rng, tmp_path):
    # residual_scale (beta) must persist through the metadata sidecar:
    # the asymmetric query affine is derived from it at encode_query.
    data, queries, params, idx = _res_pair(
        rng, "bq", DistanceType.DOT, False, count=2000, nlist=4
    )
    ivf = idx[True]
    ivf.save(tmp_path / "bq.bin", tmp_path / "bq.json")
    back = IVFIndex.load(tmp_path / "bq.bin", tmp_path / "bq.json", params)
    assert back.metadata.residual
    assert back.metadata.residual_scale == ivf.metadata.residual_scale > 0
    a_s, a_i = ivf.top_k(ivf.encode_query(queries), K)
    b_s, b_i = back.top_k(back.encode_query(queries), K)
    np.testing.assert_allclose(
        np.asarray(a_s), np.asarray(b_s), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_array_equal(np.asarray(a_i), np.asarray(b_i))


@pytest.mark.parametrize(
    "kind,dt",
    [
        ("sq", DistanceType.DOT),
        ("sq", DistanceType.L2),
        ("bq", DistanceType.DOT),
    ],
)
def test_residual_query_batch_independence(rng, kind, dt):
    # Each residual query carries its OWN code scale aq = max|q_i|/127
    # (the kernels take a per-query multiplier column), so a query's
    # quantization — codes AND returned scores — must not depend on
    # which other queries share the batch. The adversarial companion is
    # 1000x the data scale: under the old batch-global scale it would
    # zero out every other query's codes.
    data, queries, params, idx = _res_pair(
        rng, kind, dt, False, count=2000, nlist=4
    )
    ivf = idx[True]
    big = (
        1000.0 * rng.standard_normal((1, DIM)).astype(np.float32)
    )
    mixed = np.concatenate([queries, big], axis=0)

    # 1. Query-side encoding of row i is bit-identical solo vs mixed.
    _, eq_solo = ivf.encode_query(queries)
    _, eq_mix = ivf.encode_query(mixed)
    nq = queries.shape[0]
    if kind == "sq":
        np.testing.assert_array_equal(
            np.asarray(eq_solo.codes), np.asarray(eq_mix.codes)[:nq]
        )
        np.testing.assert_array_equal(
            np.asarray(eq_solo.offsets), np.asarray(eq_mix.offsets)[:nq]
        )
        np.testing.assert_array_equal(
            np.asarray(eq_solo.mult), np.asarray(eq_mix.mult)[:nq]
        )
    else:
        np.testing.assert_array_equal(
            np.asarray(eq_solo.codes), np.asarray(eq_mix.codes)[:nq]
        )
        np.testing.assert_array_equal(
            np.asarray(eq_solo.mult), np.asarray(eq_mix.mult)[:nq]
        )
        np.testing.assert_array_equal(
            np.asarray(eq_solo.qb), np.asarray(eq_mix.qb)[:nq]
        )

    # 2. End-to-end: the small queries' results are unchanged by the
    # companion (full-union scan so bucket probing can't differ).
    sv_a, id_a = ivf.top_k(
        (jnp.asarray(queries), eq_solo), K, method="exact",
        nscan=ivf.metadata.nbuckets,
    )
    sv_b, id_b = ivf.top_k(
        (jnp.asarray(mixed), eq_mix), K, method="exact",
        nscan=ivf.metadata.nbuckets,
    )
    np.testing.assert_array_equal(np.asarray(id_a), np.asarray(id_b)[:nq])
    np.testing.assert_allclose(
        np.asarray(sv_a), np.asarray(sv_b)[:nq], rtol=1e-6, atol=1e-6
    )


def test_residual_as_two_stage_coarse(rng):
    # The serving shape: residual coarse -> exact f32 rescore.
    data, queries = res_corpus(rng, 3000, DIM, queries=16)
    params = VectorParameters(DIM, 3000, DistanceType.L2, True)
    gt = gt_topk(queries, data, DistanceType.L2, True)
    ivf = IVFIndex.encode(
        data, params, quantizer="pq", nlist=6, bucket_size=512,
        nprobe=4, chunk_size=2, residual=True,
    )
    two = TwoStageIndex(
        ivf, ExactRescorer(data, DistanceType.L2, True), oversampling=6
    )
    r2 = recall(two.top_k(two.encode_query(queries), K)[1], gt)
    assert r2 > 0.9


def _check_against_reference(ivf, queries, eq, sv, ids, *, nprobe=None,
                             nscan=None, rtol=1e-5, atol=1e-4):
    """IVF ``top_k`` vs the numpy dense reference over the same union
    (tests/_ivf_reference.py)."""
    meta = ivf.metadata
    nb = meta.nbuckets
    p = min(int(nprobe or meta.nprobe), nb)
    nscan = nscan if nscan is not None else meta.nscan
    u = max(min(int(nscan) if nscan else 4 * p, nb), p)
    union = ref.union_buckets(
        ivf.bucket_means, queries, ivf.params.distance_type,
        ivf.params.invert, p, u,
    )
    eq_arrays, inner = ivf._family_arrays(eq[1])
    if meta.kind == "pq":
        inner = (np.asarray(ivf.quantizer.codes),)
        if meta.residual:
            inner = inner + (np.asarray(ivf._resid_pq),)
    top, by_id = ref.reference_topk(
        meta.kind, queries, eq_arrays, inner, np.asarray(ivf._slot_ids_dev),
        union, meta.bucket_size, K, dim=ivf.params.dim,
        dt=ivf.params.distance_type, invert=ivf.params.invert,
        means=ivf.bucket_means,
        corr_scale=(float(ivf._corr_scale_dev) if meta.residual else None),
    )
    ref.assert_matches_reference(sv, ids, top, by_id, rtol=rtol, atol=atol)


@pytest.mark.parametrize(
    "kind,method",
    [("sq", "approx"), ("sq", "exact"), ("bq", "approx")],
)
def test_indexed_scan_chunking_matches_unchunked(rng, kind, method):
    # Whole-union scans (every bucket) must equal the dense reference
    # over all slots: the compact gather, slot-id map and dedupe lose
    # nothing however wide the union.
    count = 3000
    data = clustered(rng, count, DIM, clusters=8, sigma=0.08)
    queries = clustered(rng, 8, DIM, clusters=8, sigma=0.08)
    params = VectorParameters(DIM, count, DistanceType.DOT, False)
    ivf = IVFIndex.encode(
        data, params, quantizer=kind, nlist=8, bucket_size=512, nprobe=8,
    )
    eq = ivf.encode_query(queries)
    nb = ivf.metadata.nbuckets
    sv, ids = ivf.top_k(eq, K, method=method, nscan=nb)
    _check_against_reference(ivf, queries, eq, sv, ids, nscan=nb)


@pytest.mark.parametrize(
    "kind,method,bucket,same_tile",
    [
        ("sq", "exact", 512, True),
        ("sq", "approx", 512, True),
        ("sq", "approx", 1024, False),
        ("bq", "approx", 512, False),
        ("pq", "approx", 1024, True),
        ("pq", "approx", 512, False),
    ],
)
def test_ivf_indexed_scan_matches_compact(
    rng, kind, method, bucket, same_tile
):
    # scan="auto" and scan="compact" are the same gathered scan and both
    # equal the dense reference over the probed union; scan="indexed"
    # (the removed in-place scan) raises with a pointer to ROADMAP.
    count = 3000
    data = clustered(rng, count, DIM, clusters=8, sigma=0.08)
    queries = clustered(rng, 8, DIM, clusters=8, sigma=0.08)
    params = VectorParameters(DIM, count, DistanceType.DOT, False)
    kw = {"chunk_size": 4} if kind == "pq" else {}
    ivf = IVFIndex.encode(
        data, params, quantizer=kind, nlist=8, bucket_size=bucket, nprobe=4,
        **kw,
    )
    eq = ivf.encode_query(queries)
    a_s, a_i = ivf.top_k(eq, K, method=method, scan="auto")
    c_s, c_i = ivf.top_k(eq, K, method=method, scan="compact")
    np.testing.assert_array_equal(a_s, c_s)
    np.testing.assert_array_equal(a_i, c_i)
    _check_against_reference(ivf, queries, eq, c_s, c_i)
    with pytest.raises(ArgumentsError, match="ROADMAP"):
        ivf.top_k(eq, K, method=method, scan="indexed")
    with pytest.raises(ArgumentsError):
        ivf.top_k(eq, K, scan="bogus")


@pytest.mark.parametrize("kind", ["sq", "pq", "bq"])
def test_ivf_fused_path_matches_xla(rng, kind):
    # A probe-limited search (nprobe=4 of 8 lists, small buckets, so
    # pad slots and the dedupe margin are exercised) equals the dense
    # reference over the same union.
    count = 900
    data = clustered(rng, count, DIM, clusters=8, sigma=0.08)
    queries = clustered(rng, 8, DIM, clusters=8, sigma=0.08)
    params = VectorParameters(DIM, count, DistanceType.DOT, False)
    kw = {"chunk_size": 2} if kind == "pq" else {}
    ivf = IVFIndex.encode(
        data, params, quantizer=kind, nlist=8, bucket_size=64,
        nprobe=4, **kw,
    )
    eq = ivf.encode_query(queries)
    sv, ids = ivf.top_k(eq, K, nprobe=4)
    assert np.all(np.asarray(ids) >= 0)
    _check_against_reference(ivf, queries, eq, sv, ids, nprobe=4)


@pytest.mark.parametrize(
    "kind,method,lut",
    [
        ("sq", "exact", None),
        ("sq", "approx", None),
        ("pq", "approx", "bf16"),
        ("pq", "exact", None),
        ("pq", "approx", None),
        ("pq", "approx", "int8"),
        ("bq", "exact", None),
        ("bq", "approx", None),
    ],
)
def test_residual_fused_matches_xla(rng, kind, method, lut):
    # Residual search (inner codes of v - c_b, the bucket term q . c_b
    # restored at search, pad slots masked) equals the dense numpy
    # reference of the dot-expansion over the same union. ``lut`` names
    # the removed kernels' LUT encodings; every case now scores the f32
    # LUT, so the cases differ only in method.
    del lut
    dt = DistanceType.DOT if kind == "bq" else DistanceType.L2
    data, queries, params, idx = _res_pair(
        rng, kind, dt, kind != "bq", count=2500, nlist=4
    )
    ivf = idx[True]
    eq = ivf.encode_query(queries)
    sv, ids = ivf.top_k(eq, K, method=method, nprobe=4)
    assert np.all(np.asarray(ids) >= 0)
    _check_against_reference(ivf, queries, eq, sv, ids, nprobe=4)


@pytest.mark.parametrize("scan", ["compact", "indexed"])
def test_residual_pq_default_lut(rng, scan):
    # The default residual-PQ path: compact equals the dense reference;
    # the removed indexed scan raises.
    data, queries, params, idx = _res_pair(
        rng, "pq", DistanceType.L2, True, count=2500, nlist=4
    )
    ivf = idx[True]
    eq = ivf.encode_query(queries)
    if scan == "indexed":
        with pytest.raises(ArgumentsError, match="ROADMAP"):
            ivf.top_k(eq, K, method="approx", scan=scan, nprobe=4)
        return
    sv, ids = ivf.top_k(eq, K, method="approx", scan=scan, nprobe=4)
    assert np.all(np.asarray(ids) >= 0)
    _check_against_reference(ivf, queries, eq, sv, ids, nprobe=4)


@pytest.mark.parametrize(
    "kind,method", [("sq", "exact"), ("sq", "approx"), ("pq", "approx")]
)
def test_residual_indexed_scan_matches_compact(rng, kind, method):
    # Residual corrections over a whole-union scan equal the reference,
    # and scan="indexed" raises.
    data, queries, params, idx = _res_pair(
        rng, kind, DistanceType.L2, True, count=2500, nlist=4
    )
    ivf = idx[True]
    eq = ivf.encode_query(queries)
    nb = ivf.metadata.nbuckets
    sv, ids = ivf.top_k(eq, K, method=method, nscan=nb)
    _check_against_reference(ivf, queries, eq, sv, ids, nscan=nb)
    with pytest.raises(ArgumentsError, match="ROADMAP"):
        ivf.top_k(eq, K, method=method, scan="indexed")


def test_ivf_pq_transposed_first_quantizer(rng):
    # An IVFIndex wrapping a transposed-first PQ quantizer (capacity
    # layout) must search identically to the row-major one — the scan
    # gathers the union's columns from the quantizer's own [Mpad, Npad]
    # storage and never materializes the row-major copy, and residual
    # row terms derive from it directly.
    import jax.numpy as jnp

    from quantization_tpu.models.pq import ProductQuantizer

    data, queries = res_corpus(rng, 3000, DIM)
    params = VectorParameters(DIM, 3000, DistanceType.DOT, False)
    for residual in (False, True):
        ivf = IVFIndex.encode(
            data, params, quantizer="pq", nlist=4, bucket_size=512,
            chunk_size=2, residual=residual, seed=0,
        )
        qz_t = ProductQuantizer.from_transposed(
            jnp.transpose(ivf.quantizer.codes), ivf.quantizer.metadata
        )
        ivf_t = IVFIndex(
            qz_t, ivf.bucket_ids, ivf.bucket_means, ivf.metadata
        )
        assert qz_t._codes is None  # nothing materialized the row copy
        eq = ivf.encode_query(queries)
        eq_t = ivf_t.encode_query(queries)
        for scan in ("auto", "compact"):
            s1, i1 = ivf.top_k(eq, K, method="exact", scan=scan,
                               nscan=ivf.metadata.nbuckets)
            s2, i2 = ivf_t.top_k(eq_t, K, method="exact", scan=scan,
                                 nscan=ivf.metadata.nbuckets)
            np.testing.assert_array_equal(i1, i2)
            np.testing.assert_allclose(
                np.asarray(s1), np.asarray(s2), rtol=1e-5, atol=1e-5
            )
        assert qz_t._codes is None  # the searches left it unmaterialized
