"""Serving auto-config (quantization_tpu/policy.py): the measured
frontier as an API (VERDICT r3 weak #6 / next-round #5).

Pinned: auto_geometry encodes the geometry rules (S = 1024 for large
corpora, nlist*S ~ N/3, residual bucket floor); default-built IVF-PQ gets
that geometry and searches; recommend's calibration sweep lands within
tolerance of the target recall on SQ / BQ / IVF variants and replays;
unreachable targets are reported honestly."""

import numpy as np
import pytest

from quantization_tpu.core.types import DistanceType, VectorParameters
from quantization_tpu.models.bq import BinaryQuantizer
from quantization_tpu.models.ivf import IVFIndex, auto_geometry
from quantization_tpu.models.sq import ScalarQuantizerU8
from quantization_tpu.policy import (
    ServingPlan,
    exact_topk,
    recall_at_k,
    recommend,
)

DIM = 48
K = 10


def clustered(rng, count, dim, clusters=24, sigma=0.3):
    centers = rng.standard_normal((clusters, dim)).astype(np.float32)
    assign = rng.integers(0, clusters, count)
    return (
        centers[assign]
        + sigma * rng.standard_normal((count, dim)).astype(np.float32)
    ).astype(np.float32)


def test_auto_geometry_rules():
    # Big corpus: widest tile, nlist * S ~ N/3.
    nlist, s = auto_geometry(10_000_000)
    assert s == 1024
    assert abs(nlist * s - 10_000_000 / 3) / (10_000_000 / 3) < 0.01
    # Small corpora halve S to keep probing headroom; never below 32.
    assert auto_geometry(10_000)[1] < 1024
    assert auto_geometry(100)[1] == 32
    assert auto_geometry(100)[0] >= 1
    # Residual floors S at ops.ivf.RESIDUAL_ALIGN.
    assert auto_geometry(100, residual=True)[1] == 512
    # Monotone: more rows never shrink the bucket.
    sizes = [auto_geometry(n)[1] for n in (10**3, 10**4, 10**5, 10**7)]
    assert sizes == sorted(sizes)


def test_default_ivf_pq_geometry(rng):
    # A default-built IVF-PQ takes the large-corpus geometry (S = 1024,
    # PQ's row alignment) with nlist * S well under N, and searches.
    from quantization_tpu.ops import pq as pq_ops

    count = 30_000
    data = clustered(rng, count, DIM)
    params = VectorParameters(DIM, count, DistanceType.DOT, False)
    ivf = IVFIndex.encode(data, params, quantizer="pq", chunk_size=4)
    s = ivf.metadata.bucket_size
    assert s == 1024 == pq_ops.ROW_ALIGN
    assert ivf.metadata.nlist * s <= count / 2
    sv, ids = ivf.top_k(ivf.encode_query(data[:4]), K)
    assert sv.shape == (4, K) and np.all(ids >= 0)
    # Pinning one knob still derives the other.
    ivf2 = IVFIndex.encode(
        data[:6000], VectorParameters(DIM, 6000, DistanceType.DOT, False),
        quantizer="sq", bucket_size=128,
    )
    assert ivf2.metadata.bucket_size == 128
    assert ivf2.metadata.nlist == 6000 // (3 * 128)


def test_recommend_static_seed(rng):
    count = 6000
    data = clustered(rng, count, DIM)
    params = VectorParameters(DIM, count, DistanceType.DOT, False)
    ivf = IVFIndex.encode(data, params, quantizer="sq")
    plan = recommend(ivf, 0.95)
    assert plan.nscan is not None and 1 <= plan.nscan <= ivf.metadata.nbuckets
    assert plan.oversampling > 1.0  # target above coarse ceiling -> rescore
    assert not plan.calibrated
    low = recommend(ivf, 0.4)
    assert low.oversampling == 1.0  # coarse-only regime
    assert low.nscan < plan.nscan or plan.nscan == ivf.metadata.nbuckets


@pytest.mark.parametrize("family", ["ivf-sq", "sq", "bq"])
def test_recommend_calibrates_to_target(rng, family):
    count = 12_000
    data = clustered(rng, count, DIM)
    queries = clustered(rng, 24, DIM)
    params = VectorParameters(DIM, count, DistanceType.DOT, False)
    if family == "ivf-sq":
        index = IVFIndex.encode(data, params, quantizer="sq")
        target = 0.9
    elif family == "sq":
        index = ScalarQuantizerU8.encode(data, params)
        target = 0.95
    else:
        index = BinaryQuantizer.encode(data, params)
        target = 0.7
    plan = recommend(
        index, target, k=K, queries=queries, data=data, q_batch=24
    )
    assert plan.calibrated
    assert plan.expected_recall >= target - 0.02
    # Replay: building the plan reproduces the measured recall.
    obj = plan.build(index, data, k=K)
    _, gt = exact_topk(
        queries, data, params.distance_type, params.invert, K
    )
    _, ids = obj.top_k(obj.encode_query(queries), K)
    assert abs(recall_at_k(ids, np.asarray(gt)) - plan.expected_recall) < 1e-9
    # The sweep recorded its trajectory.
    assert plan.history and plan.history[-1][1] == plan.expected_recall


def test_recommend_reports_unreachable(rng):
    # All-positive corpus: every sign code identical, BQ cannot rank —
    # even the deepest ladder rung misses 0.9 and the plan says so.
    count = 4000
    data = rng.random((count, DIM)).astype(np.float32)
    queries = rng.random((6, DIM)).astype(np.float32)
    params = VectorParameters(DIM, count, DistanceType.DOT, False)
    bq = BinaryQuantizer.encode(data, params)
    plan = recommend(bq, 0.9, k=K, queries=queries, data=data)
    assert plan.calibrated
    assert plan.expected_recall < 0.88
    assert "unreachable" in plan.notes


def test_plan_requires_data_for_rescore(rng):
    count = 2000
    data = clustered(rng, count, DIM)
    params = VectorParameters(DIM, count, DistanceType.DOT, False)
    sq = ScalarQuantizerU8.encode(data, params)
    plan = ServingPlan(oversampling=4.0)
    from quantization_tpu.core.types import ArgumentsError

    with pytest.raises(ArgumentsError):
        plan.build(sq)


def test_coarse_only_plan_on_full_scan_index(rng):
    """A coarse-only plan over a full-scan quantizer must not forward
    IVF-only knobs (scan=) to top_k — SQ/BQ/PQ also have .metadata, so
    the pin must test for the IVF-only field (r4 review finding)."""
    count = 2000
    data = clustered(rng, count, DIM)
    params = VectorParameters(DIM, count, DistanceType.DOT, False)
    sq = ScalarQuantizerU8.encode(data, params)
    queries = clustered(rng, 8, DIM)
    # Seeded coarse-only plan (target below the SQ rescore threshold).
    plan = recommend(sq, 0.5)
    assert plan.oversampling <= 1.0
    obj = plan.build(sq)
    _, ids = obj.top_k(obj.encode_query(queries), K)
    assert np.asarray(ids).shape == (8, K)
    # The calibration sweep's first trial is the same coarse-only shape.
    plan = recommend(sq, 0.5, k=K, queries=queries, data=data)
    assert plan.calibrated


def test_seed_fraction_curve():
    """Pin the uncalibrated seed curve at Q in {1, 32, 256, 1024}
    (VERDICT r4 #7). The batch-diversity scaling follows the measured
    power law (Q=32 needs ~1/5 the fraction of Q=256, not the 1/8 a
    linear model predicts), is monotone in Q and in target, floors at
    1%, and saturates at the table's last row for targets above the
    coarse ceiling."""
    from quantization_tpu.policy import (
        _IVF_FRACTION_CURVE,
        _SEED_FRACTION_FLOOR,
        _seed_fraction,
    )

    # Q=256 reproduces the measured table rows (+ floor).
    for f_meas, r_meas in _IVF_FRACTION_CURVE:
        assert _seed_fraction(r_meas, 256) == pytest.approx(
            f_meas + _SEED_FRACTION_FLOOR
        )
    # Anchor ratio: Q=32 scans ~1/5 of Q=256's fraction (measured), far
    # from the linear model's 1/8.
    f256 = _seed_fraction(0.8, 256) - _SEED_FRACTION_FLOOR
    f32 = _seed_fraction(0.8, 32) - _SEED_FRACTION_FLOOR
    assert f32 / f256 == pytest.approx(1 / 5, rel=0.05)
    assert abs(f32 / f256 - 1 / 8) > 0.05
    # Monotone in Q, bounded, floored.
    fr = [_seed_fraction(0.8, q) for q in (1, 32, 256, 1024)]
    assert fr == sorted(fr)
    assert all(_SEED_FRACTION_FLOOR <= f <= 1.0 for f in fr)
    assert _seed_fraction(0.8, 1) < 0.02  # Q=1: the measured ~1% regime
    # Target above the table's span saturates at the last measured row.
    assert _seed_fraction(0.99, 256) == _seed_fraction(
        _IVF_FRACTION_CURVE[-1][1], 256
    )
    # Monotone in target at fixed Q.
    ft = [_seed_fraction(t, 256) for t in (0.1, 0.5, 0.8, 0.87)]
    assert ft == sorted(ft)


@pytest.mark.parametrize("q_batch", [8, 32])
def test_seed_lands_within_two_rungs_of_calibration(rng, q_batch):
    """The uncalibrated seed must land in the right REGIME: calibration
    moves at most two ladder rungs (nscan doublings) from the seeded
    nscan (VERDICT r4 #7's bound). Exercised at two batch sizes so the
    Q-diversity scaling, not just the Q=256 anchor, is covered."""
    import math

    count = 12_000
    data = clustered(rng, count, DIM)
    queries = clustered(rng, q_batch, DIM)
    params = VectorParameters(DIM, count, DistanceType.DOT, False)
    # bucket_size=64: enough buckets (~65) that the fraction curve is
    # meaningful at CPU-test scale AND nlist exceeds the fixture's 24
    # true clusters (probe geometry resolves them — the regime the
    # measured curve describes; at nlist below the cluster count probe
    # loss is a k-means artifact no seed can predict).
    ivf = IVFIndex.encode(data, params, quantizer="sq", bucket_size=64)
    target = 0.85
    seeded = recommend(ivf, target, q_batch=q_batch)
    plan = recommend(
        ivf, target, k=K, queries=queries, data=data, q_batch=q_batch
    )
    assert plan.calibrated and seeded.nscan >= 1
    rungs = abs(math.log2(max(plan.nscan, 1) / seeded.nscan))
    assert rungs <= 2.0, (seeded.nscan, plan.nscan, plan.history)


@pytest.mark.parametrize("family", ["ivf-sq", "sq"])
def test_recommend_composes_with_sharded_engines(rng, family):
    """policy x sharded (VERDICT r4 #5): recommend() calibrates against a
    sharded index end-to-end on the 8-device mesh, and a rescored plan's
    build() selects ShardedExactRescorer over the INDEX'S OWN mesh — no
    full-corpus f32 funnel through one device."""
    from quantization_tpu.models.pipeline import TwoStageIndex
    from quantization_tpu.parallel.sharded import (
        ShardedExactRescorer,
        ShardedScalarQuantizer,
        make_mesh,
    )
    from quantization_tpu.parallel.sharded_ivf import ShardedIVF

    count = 12_000
    data = clustered(rng, count, DIM)
    queries = clustered(rng, 24, DIM)
    params = VectorParameters(DIM, count, DistanceType.DOT, False)
    mesh = make_mesh()
    assert mesh.shape["shard"] == 8  # conftest's virtual mesh
    if family == "ivf-sq":
        index = ShardedIVF(
            IVFIndex.encode(data, params, quantizer="sq"), mesh
        )
        target = 0.9
    else:
        index = ShardedScalarQuantizer(
            ScalarQuantizerU8.encode(data, params), mesh
        )
        target = 0.95
    plan = recommend(
        index, target, k=K, queries=queries, data=data, q_batch=24
    )
    assert plan.calibrated
    assert plan.expected_recall >= target - 0.02
    obj = plan.build(index, data, k=K)
    if plan.oversampling > 1.0:
        assert isinstance(obj, TwoStageIndex)
        assert isinstance(obj.fine, ShardedExactRescorer)
        assert obj.fine.mesh is index.mesh
    # Replay through the built object reproduces the measured recall.
    _, gt = exact_topk(
        queries, data, params.distance_type, params.invert, K
    )
    _, ids = obj.top_k(obj.encode_query(queries), K)
    assert abs(recall_at_k(ids, np.asarray(gt)) - plan.expected_recall) < 1e-9


def test_recommend_does_not_mutate_index(rng):
    """Calibration trials and discarded plans leave index.metadata.nscan
    untouched: plans pin nscan in the returned object, not the index
    (r4 review finding — a failed sweep used to leave nscan=nbuckets
    behind, silently turning the default search into a full scan)."""
    count = 4000
    data = clustered(rng, count, DIM)
    params = VectorParameters(DIM, count, DistanceType.DOT, False)
    ivf = IVFIndex.encode(data, params, quantizer="sq")
    before = ivf.metadata.nscan
    queries = clustered(rng, 8, DIM)
    plan = recommend(ivf, 0.99, k=K, queries=queries, data=data)
    assert ivf.metadata.nscan == before
    obj = plan.build(ivf, data, k=K)
    _, ids = obj.top_k(obj.encode_query(queries), K)
    assert np.asarray(ids).shape == (8, K)
    assert ivf.metadata.nscan == before
