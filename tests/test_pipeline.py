"""Two-stage retrieval tests: BQ coarse -> {SQ, PQ, exact} rescore, plus
score_candidates parity for every quantizer."""

import numpy as np
import pytest

from quantization_tpu.core.distances import pairwise_score
from quantization_tpu.core.types import DistanceType, VectorParameters
from quantization_tpu.models.bq import BinaryQuantizer
from quantization_tpu.models.pipeline import ExactRescorer, TwoStageIndex
from quantization_tpu.models.pq import ProductQuantizer
from quantization_tpu.models.sq import ScalarQuantizerU8

N, DIM, Q, K = 2000, 64, 4, 10


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(7)
    data = rng.standard_normal((N, DIM)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    queries = rng.standard_normal((Q, DIM)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    return data, queries


def exact_top(data, queries, dt, invert, k):
    scores = np.asarray(pairwise_score(queries, data, dt, invert))
    return np.argsort(-scores, axis=1)[:, :k]


@pytest.mark.parametrize("quantizer_cls", ["sq", "pq", "bq", "exact"])
def test_score_candidates_matches_score_points(dataset, quantizer_cls):
    data, queries = dataset
    params = VectorParameters(DIM, N, DistanceType.L2, True)
    if quantizer_cls == "sq":
        enc = ScalarQuantizerU8.encode(data, params)
    elif quantizer_cls == "pq":
        enc = ProductQuantizer.encode(data, params, chunk_size=4)
    elif quantizer_cls == "bq":
        enc = BinaryQuantizer.encode(data, params)
    else:
        enc = ExactRescorer(data, DistanceType.L2, True)
    eq = enc.encode_query(queries)
    rng = np.random.default_rng(3)
    cand = rng.integers(0, N, (Q, 17))
    got = np.asarray(enc.score_candidates(eq, cand))
    assert got.shape == (Q, 17)
    if quantizer_cls == "exact":
        want = np.asarray(pairwise_score(queries, data, DistanceType.L2, True))
    else:
        want = np.asarray(enc.score_batch(eq))
    for qi in range(Q):
        np.testing.assert_allclose(
            got[qi], want[qi][cand[qi]], rtol=1e-5, atol=1e-3
        )


@pytest.mark.parametrize("fine_kind", ["sq", "exact"])
def test_two_stage_recall_beats_coarse(dataset, fine_kind):
    data, queries = dataset
    params = VectorParameters(DIM, N, DistanceType.DOT, False)
    coarse = BinaryQuantizer.encode(data, params)
    if fine_kind == "sq":
        fine = ScalarQuantizerU8.encode(data, params)
    else:
        fine = ExactRescorer(data, DistanceType.DOT, False)
    index = TwoStageIndex(coarse, fine, oversampling=8.0)
    s, i = index.top_k(index.encode_query(queries), K)
    assert s.shape == (Q, K) and i.shape == (Q, K)
    exact = exact_top(data, queries, DistanceType.DOT, False, K)

    def recall(idx):
        return np.mean(
            [len(set(idx[q]) & set(exact[q])) / K for q in range(Q)]
        )

    r_two = recall(i)
    _, i_coarse = coarse.top_k(coarse.encode_query(queries), K)
    r_coarse = recall(np.asarray(i_coarse))
    assert r_two >= r_coarse  # rescoring can only help
    assert r_two >= 0.5


def test_two_stage_pq_fine(rng):
    """BQ coarse -> PQ rescoring (any quantizer can be the fine stage)."""
    import quantization_tpu as qt

    n, d, q = 800, 64, 6
    data = rng.random((n, d), dtype=np.float32) * 2 - 1
    queries = rng.random((q, d), dtype=np.float32) * 2 - 1
    params = qt.VectorParameters(d, n, qt.DistanceType.DOT, False)
    bq = qt.BinaryQuantizer.encode(data, params)
    pq = qt.ProductQuantizer.encode(data, params, chunk_size=4)
    two = qt.TwoStageIndex(bq, pq, oversampling=6.0)
    s, i = two.top_k(two.encode_query(queries), 10)
    assert s.shape == (q, 10) and i.shape == (q, 10)
    assert int(np.max(i)) < n and int(np.min(i)) >= 0
    # fine scores must be the PQ scores of the returned candidates
    eq = pq.encode_query(queries)
    ref = np.asarray(pq.score_candidates(eq, i))
    np.testing.assert_allclose(np.asarray(s), ref, rtol=1e-5, atol=1e-4)


def test_model_topk_approx_method(rng):
    """method='approx' on every quantizer returns valid (score, id) pairs
    with high overlap vs exact."""
    import quantization_tpu as qt

    n, d, q, k = 1500, 64, 4, 10
    data = rng.random((n, d), dtype=np.float32) * 2 - 1
    queries = rng.random((q, d), dtype=np.float32) * 2 - 1
    params = qt.VectorParameters(d, n, qt.DistanceType.DOT, False)
    for enc in (
        qt.ScalarQuantizerU8.encode(data, params),
        qt.BinaryQuantizer.encode(data, params),
        qt.ProductQuantizer.encode(data, params, chunk_size=4),
    ):
        eq = enc.encode_query(queries)
        se, ie = enc.top_k(eq, k, method="exact")
        sa, ia = enc.top_k(eq, k, method="approx")
        assert sa.shape == (q, k)
        for r in range(q):
            overlap = len(set(ia[r].tolist()) & set(ie[r].tolist())) / k
            assert overlap >= 0.7, (type(enc).__name__, overlap)


def test_exact_rescorer_host_resident_matches_device(rng):
    """host_resident=True gathers candidate rows on the host (memmap-safe)
    and must produce identical scores to the device-resident rescorer."""
    import numpy as np

    n, dim, q, r = 200, 24, 3, 11
    data = rng.random((n, dim), dtype=np.float32)
    queries = rng.random((q, dim), dtype=np.float32)
    cand = rng.integers(0, n, (q, r)).astype(np.int32)
    dev = ExactRescorer(data, DistanceType.L2, True)
    host = ExactRescorer(data, DistanceType.L2, True, host_resident=True)
    eq_d, eq_h = dev.encode_query(queries), host.encode_query(queries)
    np.testing.assert_allclose(
        np.asarray(host.score_candidates(eq_h, cand)),
        np.asarray(dev.score_candidates(eq_d, cand)),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(host.score_points(eq_h, cand[0])),
        np.asarray(dev.score_points(eq_d, cand[0])),
        rtol=1e-6,
    )


@pytest.mark.parametrize("dt", [DistanceType.DOT, DistanceType.L2])
def test_pq_lut_scores_match_float64(rng, dt):
    """The PQ scan over the f32 LUT (the one PQ scoring path) equals a
    float64 numpy gather-sum of the same LUT, up to f32 summation
    rounding; an L2-like LUT (all-positive entries with a large common
    offset) is the regime where rounding is largest."""
    import jax.numpy as jnp

    from quantization_tpu.ops import pq as pq_ops

    n, m, q = 300, 8, 4
    codes = rng.integers(0, 256, (n, m), dtype=np.uint8)
    lut = rng.random((q, m, 256), dtype=np.float32)
    if dt == DistanceType.L2:
        lut = lut + np.float32(10.0)
    got = np.asarray(pq_ops.score_lut_xla(jnp.asarray(lut), jnp.asarray(codes)))
    terms = lut.astype(np.float64)[:, np.arange(m)[None, :], codes]
    tol = m * 2.0 ** -23 * np.abs(terms).sum(axis=2)
    assert np.all(np.abs(got - terms.sum(axis=2)) <= tol)
