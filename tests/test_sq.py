"""SQ u8 oracle-property tests — the JAX port of the reference test strategy
(quantization/tests/test_simple.rs): seeded random data, quantized score within
``dim * 0.1`` of the exact f32 score, for every (query, point) pair, across
dot/l1/l2 x {plain, inverted}, plus score_internal, quantile edge cases, the
empty corpus, save/load, and cancellation.
"""

import numpy as np
import pytest

from quantization_tpu import (
    DistanceType,
    ScalarQuantizerU8,
    StoppedError,
    VectorParameters,
)
from quantization_tpu.core.distances import pairwise_score

# Odd sizes exercise the lane-padding path (reference uses dim=65, count=129).
DIM = 65
COUNT = 129
QUERIES = 5
ERROR_BOUND = DIM * 0.1


def make_data(rng, count=COUNT, dim=DIM):
    return rng.random((count, dim), dtype=np.float32)


def oracle(queries, data, dt, invert):
    return np.asarray(pairwise_score(queries, data, dt, invert))


@pytest.mark.parametrize("dt", [DistanceType.DOT, DistanceType.L1, DistanceType.L2])
@pytest.mark.parametrize("invert", [False, True])
def test_sq_score_vs_oracle(rng, dt, invert):
    data = make_data(rng)
    queries = make_data(rng, count=QUERIES)
    params = VectorParameters(DIM, COUNT, dt, invert)
    enc = ScalarQuantizerU8.encode(data, params)
    eq = enc.encode_query(queries)
    got = np.asarray(enc.score_batch(eq))
    want = oracle(queries, data, dt, invert)
    assert got.shape == (QUERIES, COUNT)
    np.testing.assert_allclose(got, want, atol=ERROR_BOUND)


@pytest.mark.parametrize("dt", [DistanceType.DOT, DistanceType.L1, DistanceType.L2])
def test_sq_score_points_and_point(rng, dt):
    data = make_data(rng)
    params = VectorParameters(DIM, COUNT, dt, False)
    enc = ScalarQuantizerU8.encode(data, params)
    q = make_data(rng, count=1)[0]
    eq = enc.encode_query(q)
    full = np.asarray(enc.score_batch(eq))[0]
    ids = np.array([0, 7, 128, 64])
    sel = np.asarray(enc.score_points(eq, ids))[0]
    np.testing.assert_allclose(sel, full[ids], rtol=1e-6, atol=1e-4)
    assert abs(enc.score_point(eq, 7) - full[7]) < 1e-4


@pytest.mark.parametrize("invert", [False, True])
def test_sq_score_internal_dot(rng, invert):
    # Reference tests score_internal for DOT (test_simple.rs:237-304).
    data = make_data(rng)
    params = VectorParameters(DIM, COUNT, DistanceType.DOT, invert)
    enc = ScalarQuantizerU8.encode(data, params)
    ids_b = np.arange(COUNT)
    ids_a = np.zeros(COUNT, dtype=np.int64)
    got = np.asarray(enc.score_internal_batch(ids_a, ids_b))
    want = oracle(data[:1], data, DistanceType.DOT, invert)[0]
    np.testing.assert_allclose(got, want, atol=ERROR_BOUND)
    assert abs(enc.score_internal(0, 5) - got[5]) < 1e-4


@pytest.mark.parametrize("invert", [False, True])
def test_sq_score_internal_l2(rng, invert):
    data = make_data(rng)
    params = VectorParameters(DIM, COUNT, DistanceType.L2, invert)
    enc = ScalarQuantizerU8.encode(data, params)
    ids_b = np.arange(COUNT)
    ids_a = np.zeros(COUNT, dtype=np.int64)
    got = np.asarray(enc.score_internal_batch(ids_a, ids_b))
    want = oracle(data[:1], data, DistanceType.L2, invert)[0]
    np.testing.assert_allclose(got, want, atol=ERROR_BOUND)


def test_sq_quantile(rng):
    data = make_data(rng)
    params = VectorParameters(DIM, COUNT, DistanceType.DOT, False)
    enc = ScalarQuantizerU8.encode(data, params, quantile=0.95)
    q = make_data(rng, count=1)[0]
    eq = enc.encode_query(q)
    got = np.asarray(enc.score_batch(eq))[0]
    want = oracle(q[None], data, DistanceType.DOT, False)[0]
    np.testing.assert_allclose(got, want, atol=ERROR_BOUND)


def test_sq_quantile_near_one(rng):
    # quantile >= 1.0 disables the interval estimator (quantile.rs:27-29) —
    # encode must still succeed via plain min/max (test_simple.rs:307-340).
    data = make_data(rng)
    params = VectorParameters(DIM, COUNT, DistanceType.L2, False)
    enc = ScalarQuantizerU8.encode(data, params, quantile=1.0)
    q = make_data(rng, count=1)[0]
    eq = enc.encode_query(q)
    got = np.asarray(enc.score_batch(eq))[0]
    want = oracle(q[None], data, DistanceType.L2, False)[0]
    np.testing.assert_allclose(got, want, atol=ERROR_BOUND)


def test_sq_empty_roundtrip(tmp_path, rng):
    # count==0 early-out + save/load (reference empty_storage.rs).
    params = VectorParameters(DIM, 0, DistanceType.DOT, False)
    enc = ScalarQuantizerU8.encode(np.zeros((0, DIM), np.float32), params)
    data_path = tmp_path / "data.bin"
    meta_path = tmp_path / "meta.json"
    enc.save(data_path, meta_path)
    loaded = ScalarQuantizerU8.load(data_path, meta_path, params)
    assert loaded.codes.shape[0] == 0
    assert loaded.metadata.alpha == 0.0


def test_sq_save_load_roundtrip(tmp_path, rng):
    data = make_data(rng)
    params = VectorParameters(DIM, COUNT, DistanceType.L2, True)
    enc = ScalarQuantizerU8.encode(data, params, quantile=0.99)
    data_path = tmp_path / "data.bin"
    meta_path = tmp_path / "meta.json"
    enc.save(data_path, meta_path)
    loaded = ScalarQuantizerU8.load(data_path, meta_path, params)
    q = make_data(rng, count=3)
    s0 = np.asarray(enc.score_batch(enc.encode_query(q)))
    s1 = np.asarray(loaded.score_batch(loaded.encode_query(q)))
    np.testing.assert_array_equal(s0, s1)


def test_sq_stop_condition(rng):
    data = make_data(rng, count=1000)
    params = VectorParameters(DIM, 1000, DistanceType.DOT, False)
    calls = {"n": 0}

    def stop():
        calls["n"] += 1
        return calls["n"] > 2

    with pytest.raises(StoppedError):
        ScalarQuantizerU8.encode(data, params, stop_condition=stop, batch_size=100)


def test_sq_streaming_matches_array(rng):
    data = make_data(rng)
    params = VectorParameters(DIM, COUNT, DistanceType.L2, False)

    def stream():
        for i in range(0, COUNT, 17):
            yield data[i : i + 17]

    enc_a = ScalarQuantizerU8.encode(data, params)
    enc_s = ScalarQuantizerU8.encode(stream, params)
    np.testing.assert_array_equal(np.asarray(enc_a.codes), np.asarray(enc_s.codes))
    np.testing.assert_array_equal(
        np.asarray(enc_a.voffsets), np.asarray(enc_s.voffsets)
    )


def test_sq_top_k(rng):
    data = make_data(rng, count=500)
    params = VectorParameters(DIM, 500, DistanceType.L2, True)  # rank by -dist
    enc = ScalarQuantizerU8.encode(data, params)
    q = make_data(rng, count=2)
    s, i = enc.top_k(enc.encode_query(q), k=10)
    assert s.shape == (2, 10) and i.shape == (2, 10)
    # Quantized top-10 should heavily overlap exact top-10.
    want = oracle(q, data, DistanceType.L2, True)
    exact = np.argsort(-want, axis=1)[:, :10]
    for row in range(2):
        assert len(set(i[row]) & set(exact[row])) >= 8


def test_sq_l1_blocked_topk_matches_unblocked(rng, monkeypatch):
    """The corpus-blocked search path (top_k_device blocks the [Q, N]
    score matrix past ops.topk.BLOCK_ROWS) must match the flat
    score+top-k exactly; block size is shrunk so a small corpus crosses
    several block (and tail) boundaries."""
    import quantization_tpu.ops.topk as topk_ops

    n, dim, q, k = 333, 40, 3, 7
    data = rng.random((n, dim), dtype=np.float32)
    queries = rng.random((q, dim), dtype=np.float32)
    params = VectorParameters(dim, n, DistanceType.L1, True)
    enc = ScalarQuantizerU8.encode(data, params)
    eq = enc.encode_query(queries)
    s_ref, i_ref = enc.top_k(eq, k)

    monkeypatch.setattr(topk_ops, "BLOCK_ROWS", 100)
    s_got, i_got = enc.top_k(eq, k)
    np.testing.assert_allclose(s_got, s_ref, rtol=1e-5, atol=1e-4)
    # ties possible on random u8 L1 scores; assert the score multiset only
    monkeypatch.setattr(topk_ops, "BLOCK_ROWS", 64)  # k > some tail size
    s_got2, _ = enc.top_k(eq, k)
    np.testing.assert_allclose(s_got2, s_ref, rtol=1e-5, atol=1e-4)
