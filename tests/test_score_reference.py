"""Scoring and selection against plain numpy references — the analogue of
the reference's per-ISA suites (tests/test_sse.rs / test_avx2.rs /
test_neon.rs): each device op is pinned against a straightforward
implementation of the same arithmetic, exactly where the arithmetic is
integer (SQ, BQ) and within f32 summation rounding where it is not (PQ).
Selection is pinned against numpy's sort, with ids free to swap only
among tied scores."""

import jax.numpy as jnp
import numpy as np
import pytest

from quantization_tpu.core.types import DistanceType, VectorParameters
from quantization_tpu.models.bq import BinaryQuantizer
from quantization_tpu.models.pq import ProductQuantizer
from quantization_tpu.models.sq import ScalarQuantizerU8
from quantization_tpu.ops import bq as bq_ops
from quantization_tpu.ops import pq as pq_ops
from quantization_tpu.ops import sq as sq_ops
from quantization_tpu.ops.topk import top_k

# ------------------------------------------------------------ references


def sq_reference(qcodes, qoff, codes, voff, mult, dt):
    """float64 mult * kernel + qoff + voff with an exact integer kernel."""
    q = qcodes.astype(np.int64)
    c = codes.astype(np.int64)
    if dt == DistanceType.L1:
        raw = np.abs(q[:, None, :] - c[None, :, :]).sum(axis=2)
    else:
        raw = q @ c.T
    return float(mult) * raw + qoff[:, None] + voff[None, :]


def bq_reference(qdata, data, dt, invert):
    """Hamming scores of sign bits (v > 0), mapped like
    encoded_vectors_binary.rs:219-253."""
    dim = data.shape[1]
    x = ((qdata[:, None, :] > 0) != (data[None, :, :] > 0)).sum(axis=2)
    if dt == DistanceType.DOT:
        out = 2 * x - dim if invert else dim - 2 * x
    else:
        out = dim - 2 * x if invert else 2 * x - dim
    return out.astype(np.float32)


def pq_reference(lut, codes):
    """float64 sum over chunks of lut[q, m, codes[n, m]], and the f32
    rounding bound of summing those m terms in another order."""
    m = codes.shape[1]
    terms = np.asarray(lut, np.float64)[
        :, np.arange(m)[None, :], codes.astype(np.int64)
    ]
    return terms.sum(axis=2), m * 2.0 ** -23 * np.abs(terms).sum(axis=2)


def assert_topk(scores_ref, s, i, k, rtol=1e-6, atol=1e-4):
    """(s, i) is a top-k of ``scores_ref``: the values equal numpy's
    sorted top-k, ids are distinct and valid, and each id scores its slot
    (ids may differ from numpy's order only among ties)."""
    s, i = np.asarray(s), np.asarray(i)
    n = scores_ref.shape[1]
    kk = min(k, n)
    want = -np.sort(-scores_ref, axis=1)[:, :kk]
    np.testing.assert_allclose(s[:, :kk], want, rtol=rtol, atol=atol)
    for r in range(len(s)):
        row = i[r, :kk]
        assert len(set(row.tolist())) == kk, "duplicate ids"
        assert row.min() >= 0 and row.max() < n
        np.testing.assert_allclose(
            scores_ref[r, row], s[r, :kk], rtol=rtol, atol=atol
        )


def _sq_setup(rng, n, d, q, scale=None):
    codes = rng.integers(0, 128, (n, d), dtype=np.int8)
    voff = (
        rng.random(n, dtype=np.float32) if scale is None
        else np.asarray(scale, np.float32)
    )
    qcodes = rng.integers(0, 128, (q, d), dtype=np.int8)
    qoff = rng.random(q, dtype=np.float32)
    return codes, voff, qcodes, qoff


def _sq_scores(qcodes, qoff, codes, voff, mult, dt):
    return np.asarray(
        sq_ops.score_batch_xla(
            jnp.asarray(qcodes), jnp.asarray(qoff), jnp.asarray(codes),
            jnp.asarray(voff), jnp.float32(mult), distance_type=dt,
        )
    )


def _bq_planes(data, dim):
    row_bytes = bq_ops.storage_bytes(dim, "u128")
    return bq_ops.rows_to_planes(bq_ops.pack_rows(data, row_bytes))


def _signs(rng, n, dim):
    return np.sign(rng.random((n, dim), dtype=np.float32) - 0.5)


# ------------------------------------------------------------------- SQ


@pytest.mark.parametrize("dt", [DistanceType.DOT, DistanceType.L1, DistanceType.L2])
@pytest.mark.parametrize("q", [1, 5])
def test_sq_kernel_matches_xla(rng, dt, q):
    """SQ scores equal the integer reference: the kernel is exact
    (int32 accumulation), so only the final f32 affine rounds."""
    codes, voff, qcodes, qoff = _sq_setup(rng, 700, 256, q)
    got = _sq_scores(qcodes, qoff, codes, voff, 0.37, dt)
    want = sq_reference(qcodes, qoff, codes, voff, np.float32(0.37), dt)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def test_sq_int_dot_exact_past_f32_mantissa(rng):
    """int_dot is bit-exact where an f32 accumulation would round: sums
    of 1536 products of codes in [110, 127] pass 2^24."""
    qc = rng.integers(110, 128, (4, 1536), dtype=np.int8)
    cc = rng.integers(110, 128, (64, 1536), dtype=np.int8)
    got = np.asarray(sq_ops.int_dot(jnp.asarray(qc), jnp.asarray(cc)))
    want = qc.astype(np.int64) @ cc.astype(np.int64).T
    assert want.max() > 1 << 24
    np.testing.assert_array_equal(got.astype(np.int64), want)


@pytest.mark.parametrize("dt", [DistanceType.DOT, DistanceType.L2])
@pytest.mark.parametrize("k", [1, 10])
def test_sq_fused_search_matches_score_then_topk(rng, dt, k):
    """SQ top_k_device equals numpy's top-k of the reference scores."""
    n, dim = 700, 40
    data = rng.random((n, dim), dtype=np.float32)
    enc = ScalarQuantizerU8.encode(data, VectorParameters(dim, n, dt, False))
    eq = enc.encode_query(rng.random((5, dim), dtype=np.float32))
    s, i = enc.top_k_device(eq, k)
    want = sq_reference(
        np.asarray(eq.codes), np.asarray(eq.offsets),
        np.asarray(enc.codes)[:n], np.asarray(enc.voffsets)[:n],
        np.float32(enc.metadata.multiplier), dt,
    )
    assert_topk(want, s, i, k)


def test_sq_fused_approx_search(rng):
    """The approx route returns the exact top-k (ops/topk.py)."""
    codes, voff, qcodes, qoff = _sq_setup(rng, 2000, 256, 4)
    scores = _sq_scores(qcodes, qoff, codes, voff, 0.37, DistanceType.DOT)
    s, i = top_k(jnp.asarray(scores), 40, method="approx")
    want = sq_reference(qcodes, qoff, codes, voff, np.float32(0.37), DistanceType.DOT)
    assert_topk(want, s, i, 40)


@pytest.mark.parametrize("k", [100, 256, 600])
def test_sq_fused_search_exact_beyond_old_cap(rng, k):
    """Selection stays exact at wide k (two-stage and IVF candidate
    pools)."""
    codes, voff, qcodes, qoff = _sq_setup(rng, 2000, 256, 3)
    scores = _sq_scores(qcodes, qoff, codes, voff, 0.37, DistanceType.DOT)
    s, i = top_k(jnp.asarray(scores), k)
    want = sq_reference(qcodes, qoff, codes, voff, np.float32(0.37), DistanceType.DOT)
    assert_topk(want, s, i, k)


def test_sq_fused_search_adversarial_class_collision(rng):
    """All ten best rows share one residue class (ids spaced by 128), the
    pattern that defeated strided in-tile extraction: selection over the
    full score row must still find every one."""
    n = 3000
    scale = rng.random(n, dtype=np.float32)
    top_ids = np.arange(10) * 128
    scale[top_ids] = 1000.0 + np.arange(10)
    codes, voff, qcodes, qoff = _sq_setup(rng, n, 256, 2, scale=scale)
    codes[:] = 0
    qcodes[:] = 0  # voff alone orders the rows
    scores = _sq_scores(qcodes, qoff, codes, voff, 1.0, DistanceType.DOT)
    s, i = top_k(jnp.asarray(scores), 10)
    want = sq_reference(qcodes, qoff, codes, voff, np.float32(1.0), DistanceType.DOT)
    assert_topk(want, s, i, 10)
    assert set(np.asarray(i)[0].tolist()) == set(top_ids.tolist())


def test_sq_fused_search_k_exceeds_candidate_width(rng):
    """k equal to the corpus size returns every row, value-exact."""
    codes, voff, qcodes, qoff = _sq_setup(rng, 600, 256, 2)
    scores = _sq_scores(qcodes, qoff, codes, voff, 0.5, DistanceType.DOT)
    s, i = top_k(jnp.asarray(scores), 600)
    want = sq_reference(qcodes, qoff, codes, voff, np.float32(0.5), DistanceType.DOT)
    assert_topk(want, s, i, 600, atol=1e-5)


# ------------------------------------------------------------------- BQ


@pytest.mark.parametrize("dt", [DistanceType.DOT, DistanceType.L2])
@pytest.mark.parametrize("invert", [False, True])
def test_bq_kernel_matches_xla(rng, dt, invert):
    """BQ scores equal the numpy popcount reference exactly."""
    dim, n, q = 193, 300, 3
    data, qdata = _signs(rng, n, dim), _signs(rng, q, dim)
    got = np.asarray(
        bq_ops.score_batch_xla(
            jnp.asarray(_bq_planes(qdata, dim).T.copy()),
            jnp.asarray(_bq_planes(data, dim)),
            distance_type=dt, invert=invert, dim=dim,
        )
    )
    np.testing.assert_array_equal(got, bq_reference(qdata, data, dt, invert))


@pytest.mark.parametrize("dt", [DistanceType.DOT, DistanceType.L1, DistanceType.L2])
@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("dim", [33, 193, 256])
def test_bq_mxu_kernel_matches_xla(rng, dt, invert, dim):
    """The BQ model's scores (padded plane words, padded corpus) equal
    the popcount reference exactly at word-ragged and word-exact dims."""
    n, q = 300, 5
    data, qdata = _signs(rng, n, dim), _signs(rng, q, dim)
    enc = BinaryQuantizer.encode(data, VectorParameters(dim, n, dt, invert))
    got = np.asarray(enc.score_batch(enc.encode_query(qdata)))
    np.testing.assert_array_equal(got, bq_reference(qdata, data, dt, invert))


@pytest.mark.parametrize("dt", [DistanceType.DOT, DistanceType.L2])
@pytest.mark.parametrize("invert", [False, True])
def test_bq_fused_search_matches_score_then_topk(rng, dt, invert):
    """BQ top_k_device: small-integer scores tie in droves, so the score
    multiset must match exactly and ids only score their slots."""
    dim, n, q, k = 193, 900, 4, 10
    data, qdata = _signs(rng, n, dim), _signs(rng, q, dim)
    enc = BinaryQuantizer.encode(data, VectorParameters(dim, n, dt, invert))
    s, i = enc.top_k_device(enc.encode_query(qdata), k)
    assert_topk(bq_reference(qdata, data, dt, invert), s, i, k, rtol=0, atol=0)


# ------------------------------------------------------------------- PQ


@pytest.mark.parametrize("m", [7, 130])
@pytest.mark.parametrize("q", [1, 4])
def test_pq_kernel_matches_xla(rng, m, q):
    """PQ LUT scores equal the float64 gather-sum within f32 rounding."""
    n = 400
    codes = rng.integers(0, 256, (n, m), dtype=np.uint8)
    lut = rng.standard_normal((q, m, 256), dtype=np.float32)
    got = np.asarray(pq_ops.score_lut_xla(jnp.asarray(lut), jnp.asarray(codes)))
    want, tol = pq_reference(lut, codes)
    assert np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_pq_fused_search(rng, mode):
    """PQ top_k_device (either method) equals the top-k of the reference
    scores."""
    n, dim, k = 1500, 48, 10
    data = rng.random((n, dim), dtype=np.float32)
    enc = ProductQuantizer.encode(
        data, VectorParameters(dim, n, DistanceType.DOT, False), chunk_size=2
    )
    eq = enc.encode_query(rng.random((3, dim), dtype=np.float32))
    s, i = enc.top_k_device(eq, k, method=mode)
    want, tol = pq_reference(
        eq.lut, np.asarray(enc.codes)[:n, : enc.num_chunks]
    )
    assert_topk(want, s, i, k, rtol=0, atol=float(tol.max()))


@pytest.mark.parametrize("k", [10, 96])
def test_pq_fused_search_exact_stream(rng, k):
    """PQ exact selection below and above the old 64 cap."""
    n, m, q = 2100, 8, 3
    codes = rng.integers(0, 256, (n, m), dtype=np.uint8)
    lut = rng.random((q, m, 256), dtype=np.float32)
    scores = pq_ops.score_lut_xla(jnp.asarray(lut), jnp.asarray(codes))
    s, i = top_k(scores, k)
    want, tol = pq_reference(lut, codes)
    assert_topk(want, s, i, k, rtol=0, atol=float(tol.max()))


# ------------------------------------------------------ candidate gather


@pytest.mark.parametrize("shape", [(800, 256), (1024, 96)])
def test_dma_gather_rows(rng, shape):
    """score_candidates (per-query candidate gather, the two-stage
    rescore) equals score_points row by row, every family."""
    n, dim = shape
    data = rng.random((n, dim), dtype=np.float32)
    queries = rng.random((3, dim), dtype=np.float32)
    params = VectorParameters(dim, n, DistanceType.DOT, False)
    cand = rng.integers(0, n, (3, 77)).astype(np.int32)
    for enc in (
        ScalarQuantizerU8.encode(data, params),
        BinaryQuantizer.encode(data, params),
        ProductQuantizer.encode(data, params, chunk_size=8),
    ):
        eq = enc.encode_query(queries)
        got = np.asarray(enc.score_candidates(eq, cand))
        full = np.asarray(enc.score_points(eq, np.arange(n)))
        np.testing.assert_allclose(
            got, np.take_along_axis(full, cand, axis=1), rtol=1e-6, atol=1e-5
        )


def test_gather_rows_chunked_beyond_smem(rng):
    """A wide candidate pool (R = 4096 per query, ids repeated) scores
    like score_points."""
    n, dim, r = 64, 128, 4096
    data = rng.random((n, dim), dtype=np.float32)
    enc = ScalarQuantizerU8.encode(
        data, VectorParameters(dim, n, DistanceType.L2, True)
    )
    eq = enc.encode_query(rng.random((2, dim), dtype=np.float32))
    cand = rng.integers(0, n, (2, r)).astype(np.int32)
    got = np.asarray(enc.score_candidates(eq, cand))
    full = np.asarray(enc.score_points(eq, np.arange(n)))
    np.testing.assert_allclose(
        got, np.take_along_axis(full, cand, axis=1), rtol=1e-6, atol=1e-5
    )
