"""End-to-end quantizer-level checks: each model's score path against a
plain numpy reference computed from the model's own codes — exact for SQ
and BQ (integer arithmetic), within f32 summation rounding for PQ — and
top_k_device against numpy's top-k of the model's scores."""

import numpy as np
import pytest

from quantization_tpu.core.types import DistanceType, VectorParameters
from quantization_tpu.models.bq import BinaryQuantizer
from quantization_tpu.models.pq import ProductQuantizer
from quantization_tpu.models.sq import ScalarQuantizerU8

from test_score_reference import (
    assert_topk,
    bq_reference,
    pq_reference,
    sq_reference,
)


@pytest.mark.parametrize("dt", [DistanceType.DOT, DistanceType.L1])
def test_sq_model_score_path(rng, dt):
    n, dim = 600, 65
    data = rng.random((n, dim), dtype=np.float32)
    q = rng.random((3, dim), dtype=np.float32)
    enc = ScalarQuantizerU8.encode(data, VectorParameters(dim, n, dt, False))
    eq = enc.encode_query(q)
    got = np.asarray(enc.score_batch(eq))
    want = sq_reference(
        np.asarray(eq.codes), np.asarray(eq.offsets),
        np.asarray(enc.codes)[:n], np.asarray(enc.voffsets)[:n],
        np.float32(enc.metadata.multiplier), dt,
    )
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def test_bq_model_score_path(rng):
    n, dim = 500, 130
    data = np.sign(rng.random((n, dim), dtype=np.float32) - 0.5)
    q = np.sign(rng.random((2, dim), dtype=np.float32) - 0.5)
    enc = BinaryQuantizer.encode(
        data, VectorParameters(dim, n, DistanceType.L2, True)
    )
    got = np.asarray(enc.score_batch(enc.encode_query(q)))
    np.testing.assert_array_equal(
        got, bq_reference(q, data, DistanceType.L2, True)
    )


def test_pq_model_score_path(rng):
    n, dim = 400, 32
    data = rng.random((n, dim), dtype=np.float32)
    q = rng.random((2, dim), dtype=np.float32)
    enc = ProductQuantizer.encode(
        data, VectorParameters(dim, n, DistanceType.L2, True), chunk_size=2
    )
    eq = enc.encode_query(q)
    got = np.asarray(enc.score_batch(eq))
    want, tol = pq_reference(eq.lut, np.asarray(enc.codes)[:n, : enc.num_chunks])
    assert np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize("method", ["exact", "approx"])
def test_model_topk_routing(rng, method):
    """top_k_device of every family equals numpy's top-k of the family's
    own scores (both methods select exactly)."""
    n, dim, q, k = 600, 64, 3, 5
    data = rng.random((n, dim), dtype=np.float32)
    queries = rng.random((q, dim), dtype=np.float32)
    params = VectorParameters(dim, n, DistanceType.DOT, False)
    for enc in (
        ScalarQuantizerU8.encode(data, params),
        BinaryQuantizer.encode(data, params),
        ProductQuantizer.encode(data, params, chunk_size=4),
    ):
        eq = enc.encode_query(queries)
        s, i = enc.top_k_device(eq, k, method=method)
        assert_topk(np.asarray(enc.score_batch(eq)), s, i, k)


def test_approx_topk_beyond_slot(rng):
    """Approx mode at a wide coarse-stage pool (k=300) returns k valid
    results covering the exact top-k."""
    import numpy as np

    from quantization_tpu import (
        DistanceType,
        ScalarQuantizerU8,
        VectorParameters,
    )

    n, dim, q, k = 4000, 32, 3, 300
    data = rng.random((n, dim), dtype=np.float32)
    queries = rng.random((q, dim), dtype=np.float32)
    params = VectorParameters(dim, n, DistanceType.DOT, False)
    enc = ScalarQuantizerU8.encode(data, params)
    eq = enc.encode_query(queries)
    s, i = enc.top_k(eq, k, method="approx")
    assert s.shape == (q, k) and i.shape == (q, k)
    assert i.max() < n
    # the approx candidate pool must cover most of the exact top-k
    s_ref, i_ref = enc.top_k(eq, k, method="exact")
    for r in range(q):
        overlap = len(set(i[r].tolist()) & set(i_ref[r].tolist())) / k
        assert overlap >= 0.8, overlap


def test_recall_target_reaches_select(rng):
    """recall_target is accepted at every layer that takes a method
    (quantizer, IVF, two-stage, sharded) and changes nothing: every
    method selects exactly (ops/topk.py), so approx at any recall target
    equals exact."""
    from quantization_tpu.models.ivf import IVFIndex
    from quantization_tpu.models.pipeline import ExactRescorer, TwoStageIndex

    n, dim, q, k = 4000, 32, 4, 10
    data = rng.random((n, dim), dtype=np.float32)
    queries = rng.random((q, dim), dtype=np.float32)
    params = VectorParameters(dim, n, DistanceType.DOT, False)
    enc = ScalarQuantizerU8.encode(data, params)
    ivf = IVFIndex.encode(
        data, params, quantizer="sq", nlist=8, bucket_size=128, nprobe=4
    )
    two = TwoStageIndex(enc, ExactRescorer(data, DistanceType.DOT, False))
    for index in (enc, ivf, two):
        eq = index.encode_query(queries)
        want = index.top_k(eq, k, method="exact")
        for rt in (0.7, 0.99):
            got = index.top_k(eq, k, method="approx", recall_target=rt)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
