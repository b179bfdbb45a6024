"""PQ oracle tests — the JAX port of quantization/tests/test_pq.rs:
count=513, dim=65, chunk_size=1, score within ``dim * 0.05`` of exact, across
dot/l1/l2 x {plain, inverted}, plus score_internal, the count<=256 fallback,
save/load, and cancellation."""

import numpy as np
import pytest

from quantization_tpu.core.distances import pairwise_score
from quantization_tpu.core.types import DistanceType, StoppedError, VectorParameters
from quantization_tpu.models.pq import ProductQuantizer
from quantization_tpu.ops import pq as pq_ops

COUNT = 513
DIM = 65
ERROR = DIM * 0.05


def make_data(rng, count=COUNT, dim=DIM):
    return rng.random((count, dim), dtype=np.float32)


@pytest.mark.parametrize("dt", [DistanceType.DOT, DistanceType.L1, DistanceType.L2])
@pytest.mark.parametrize("invert", [False, True])
def test_pq_score_vs_oracle(rng, dt, invert):
    data = make_data(rng)
    query = make_data(rng, count=1)
    params = VectorParameters(DIM, COUNT, dt, invert)
    enc = ProductQuantizer.encode(data, params, chunk_size=1)
    got = np.asarray(enc.score_batch(enc.encode_query(query)))[0]
    want = np.asarray(pairwise_score(query, data, dt, invert))[0]
    np.testing.assert_allclose(got, want, atol=ERROR)


@pytest.mark.parametrize("invert", [False, True])
def test_pq_score_internal(rng, invert):
    data = make_data(rng)
    params = VectorParameters(DIM, COUNT, DistanceType.DOT, invert)
    enc = ProductQuantizer.encode(data, params, chunk_size=1)
    ids = np.arange(COUNT)
    got = np.asarray(enc.score_internal_batch(np.zeros(COUNT, np.int64), ids))
    want = np.asarray(
        pairwise_score(data[:1], data, DistanceType.DOT, invert)
    )[0]
    np.testing.assert_allclose(got, want, atol=ERROR)
    assert abs(enc.score_internal(0, 7) - got[7]) < 1e-5


def test_pq_chunk2(rng):
    # chunk_size=2 (the demos/benches/pq.rs config)
    data = make_data(rng)
    query = make_data(rng, count=3)
    params = VectorParameters(DIM, COUNT, DistanceType.L2, True)
    enc = ProductQuantizer.encode(data, params, chunk_size=2)
    assert enc.count == COUNT and enc.num_chunks == 33  # ceil(65/2)
    got = np.asarray(enc.score_batch(enc.encode_query(query)))
    want = np.asarray(pairwise_score(query, data, DistanceType.L2, True))
    np.testing.assert_allclose(got, want, atol=ERROR * 2)


def test_pq_small_count_fallback(rng):
    # count <= 256: centroids are the points themselves, zero-filled
    # (encoded_vectors_pq.rs:290-297) -> every point decodes exactly.
    data = make_data(rng, count=100, dim=16)
    params = VectorParameters(16, 100, DistanceType.L2, False)
    enc = ProductQuantizer.encode(data, params, chunk_size=16)
    got = np.asarray(enc.score_batch(enc.encode_query(data[:5])))
    # each point scores 0 (exact l2) against itself
    for i in range(5):
        assert abs(got[i, i]) < 1e-3


def test_pq_vector_division():
    assert pq_ops.get_vector_division(65, 2) == [
        (i, min(i + 2, 65)) for i in range(0, 65, 2)
    ]
    assert pq_ops.get_vector_division(4, 8) == [(0, 4)]


def test_pq_save_load_roundtrip(tmp_path, rng):
    data = make_data(rng)
    params = VectorParameters(DIM, COUNT, DistanceType.DOT, False)
    enc = ProductQuantizer.encode(data, params, chunk_size=2)
    enc.save(tmp_path / "d.bin", tmp_path / "m.json")
    loaded = ProductQuantizer.load(tmp_path / "d.bin", tmp_path / "m.json", params)
    q = make_data(rng, count=2)
    np.testing.assert_array_equal(
        np.asarray(enc.score_batch(enc.encode_query(q))),
        np.asarray(loaded.score_batch(loaded.encode_query(q))),
    )
    np.testing.assert_array_equal(np.asarray(enc.codes), np.asarray(loaded.codes))


def test_pq_stop_condition(rng):
    data = make_data(rng)
    params = VectorParameters(DIM, COUNT, DistanceType.DOT, False)
    with pytest.raises(StoppedError):
        ProductQuantizer.encode(
            data, params, chunk_size=1, stop_condition=lambda: True
        )


def test_pq_empty_roundtrip(tmp_path):
    params = VectorParameters(DIM, 0, DistanceType.DOT, False)
    enc = ProductQuantizer.encode(
        np.zeros((0, DIM), np.float32), params, chunk_size=1
    )
    enc.save(tmp_path / "d.bin", tmp_path / "m.json")
    loaded = ProductQuantizer.load(tmp_path / "d.bin", tmp_path / "m.json", params)
    assert loaded.codes.shape[0] == 0


def test_pq_topk_recall(rng):
    data = make_data(rng, count=1000, dim=64)
    queries = make_data(rng, count=4, dim=64)
    params = VectorParameters(64, 1000, DistanceType.L2, True)
    enc = ProductQuantizer.encode(data, params, chunk_size=2)
    s, i = enc.top_k(enc.encode_query(queries), 10)
    want = np.asarray(pairwise_score(queries, data, DistanceType.L2, True))
    exact = np.argsort(-want, axis=1)[:, :10]
    for row in range(4):
        assert len(set(i[row]) & set(exact[row])) >= 7


# --------------------------------------------------------------------- 4-bit
def test_pq4_end_to_end_and_roundtrip(rng, tmp_path):
    """4-bit PQ (Quick-ADC-style extension): encode/score/save/load; 16
    centroids per chunk, two codes per byte on disk."""
    import quantization_tpu as qt
    from quantization_tpu.models.pq import ProductQuantizer

    n, d, q = 600, 32, 5
    data = rng.random((n, d), dtype=np.float32) * 2 - 1
    queries = rng.random((q, d), dtype=np.float32) * 2 - 1
    params = qt.VectorParameters(d, n, qt.DistanceType.DOT, False)
    pq4 = ProductQuantizer.encode(data, params, chunk_size=2, bits=4)
    assert pq4.metadata.bits == 4
    assert int(np.asarray(pq4.codes).max()) < 16
    assert pq4.get_quantized_vector_size() == 8  # 16 chunks -> 8 bytes

    eq = pq4.encode_query(queries)
    assert eq.lut.shape == (q, 16, 16)
    s, i = pq4.top_k(eq, 10)
    # sanity: 4-bit ranking correlates with exact (clustered-free random
    # data: just require better than random overlap on top-10 of 600)
    exact = np.argsort(-(queries @ data.T), axis=1)[:, :10]
    overlap = np.mean([
        len(set(map(int, i[r])) & set(map(int, exact[r]))) / 10
        for r in range(q)
    ])
    assert overlap > 0.2, overlap

    dp, mp = tmp_path / "c.bin", tmp_path / "m.json"
    pq4.save(dp, mp)
    assert dp.stat().st_size == n * 8
    re = ProductQuantizer.load(dp, mp, params)
    assert re.metadata.bits == 4
    np.testing.assert_array_equal(
        np.asarray(re.codes[:n, :16]), np.asarray(pq4.codes[:n, :16])
    )
    s2, i2 = re.top_k(re.encode_query(queries), 10)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i2))


def test_pq4_lut_scores_match_reference(rng):
    # 4-bit codes (16 centroids per chunk): the LUT scan equals a float64
    # numpy gather-sum; f32 sums of m terms differ from it by rounding
    # only (at most m ulps of the running magnitude).
    from quantization_tpu.ops import pq as pq_ops
    import jax.numpy as jnp

    n, m, q = 400, 24, 3
    codes = rng.integers(0, 16, (n, m), dtype=np.uint8)
    lut = rng.standard_normal((q, m, 16), dtype=np.float32)
    got = np.asarray(pq_ops.score_lut_xla(jnp.asarray(lut), jnp.asarray(codes)))
    terms = lut.astype(np.float64)[:, np.arange(m)[None, :], codes]
    want = terms.sum(axis=2)
    tol = m * 2.0 ** -23 * np.abs(terms).sum(axis=2)
    assert np.all(np.abs(got - want) <= tol)


def test_pq_from_transposed_parity(rng):
    # Transposed-first construction (the chunk-major layout the sharded
    # engines append) must score identically to the normal constructor,
    # and materialize the row-major codes only on demand.
    import jax.numpy as jnp

    data = make_data(rng, count=600)
    params = VectorParameters(DIM, 600, DistanceType.DOT, False)
    enc = ProductQuantizer.encode(data, params, chunk_size=4)
    enc_t = ProductQuantizer.from_transposed(
        jnp.transpose(enc.codes), enc.metadata
    )
    assert enc_t._codes is None  # row-major not materialized
    q = make_data(rng, count=8)
    s1, i1 = enc.top_k(enc.encode_query(q), 10)
    s2, i2 = enc_t.top_k(enc_t.encode_query(q), 10)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, rtol=1e-6)
    # score_internal path materializes row codes lazily and agrees.
    assert enc_t.score_internal(3, 5) == pytest.approx(
        enc.score_internal(3, 5)
    )
    assert enc_t._codes is not None


def test_pq_from_transposed_save_load(rng, tmp_path):
    # A transposed-first quantizer persists the reference two-file
    # format identically (save materializes the row layout lazily) and
    # round-trips through the normal loader.
    import jax.numpy as jnp

    data = make_data(rng, count=400)
    params = VectorParameters(DIM, 400, DistanceType.L2, True)
    enc = ProductQuantizer.encode(data, params, chunk_size=4)
    enc_t = ProductQuantizer.from_transposed(
        jnp.transpose(enc.codes), enc.metadata
    )
    enc.save(tmp_path / "a.bin", tmp_path / "a.json")
    enc_t.save(tmp_path / "b.bin", tmp_path / "b.json")
    assert (tmp_path / "a.bin").read_bytes() == (
        tmp_path / "b.bin"
    ).read_bytes()
    back = ProductQuantizer.load(
        tmp_path / "b.bin", tmp_path / "b.json", params
    )
    q = make_data(rng, count=4)
    np.testing.assert_array_equal(
        enc.top_k(enc.encode_query(q), 5)[1],
        back.top_k(back.encode_query(q), 5)[1],
    )
