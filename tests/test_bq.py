"""BQ oracle tests — the JAX port of quantization/tests/test_binary.rs:
+-1-valued seeded data; DOT within ``dim * 0.01`` of exact (equality in
disguise); L1/L2 exact rank-order equality via stable argsort (reversed when
inverted); word-boundary dim sweep 0/1/8/33/65/387; both storage tiers."""

import numpy as np
import pytest

from quantization_tpu.core.types import DistanceType, StoppedError, VectorParameters
from quantization_tpu.core.distances import pairwise
from quantization_tpu.models.bq import BinaryQuantizer
from quantization_tpu.ops import bq as bq_ops

DIMS = [0, 1, 8, 33, 65, 3 * 129]
COUNT = 128


def pm1(rng, count, dim):
    """+-1-valued vectors (reference generate_vector)."""
    v = np.sign(rng.random((count, dim), dtype=np.float32) - 0.5)
    v[v == 0] = 1.0
    return v.astype(np.float32)


def stable_order(scores):
    return np.argsort(scores, kind="stable")


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("store_type", ["u8", "u128"])
@pytest.mark.parametrize("invert", [False, True])
def test_bq_dot(rng, dim, store_type, invert):
    data = pm1(rng, COUNT, dim)
    query = pm1(rng, 1, dim)
    params = VectorParameters(dim, COUNT, DistanceType.DOT, invert)
    enc = BinaryQuantizer.encode(data, params, store_type=store_type)
    got = np.asarray(enc.score_batch(enc.encode_query(query)))[0]
    want = np.asarray(pairwise(query, data, DistanceType.DOT))[0]
    if invert:
        want = -want
    np.testing.assert_allclose(got, want, atol=dim * 0.01 + 1e-6)


@pytest.mark.parametrize("dim", [33, 387])
@pytest.mark.parametrize("invert", [False, True])
def test_bq_dot_internal(rng, dim, invert):
    data = pm1(rng, COUNT, dim)
    params = VectorParameters(dim, COUNT, DistanceType.DOT, invert)
    enc = BinaryQuantizer.encode(data, params)
    ids_b = np.arange(COUNT)
    got = np.asarray(enc.score_internal_batch(np.zeros(COUNT, np.int64), ids_b))
    want = np.asarray(pairwise(data[:1], data, DistanceType.DOT))[0]
    if invert:
        want = -want
    np.testing.assert_allclose(got, want, atol=dim * 0.01 + 1e-6)
    assert abs(enc.score_internal(0, 5) - got[5]) < 1e-6


@pytest.mark.parametrize("dim", [1, 8, 33, 65, 3 * 129])
@pytest.mark.parametrize("dt", [DistanceType.L1, DistanceType.L2])
@pytest.mark.parametrize("invert", [False, True])
def test_bq_rank_order(rng, dim, dt, invert):
    data = pm1(rng, COUNT, dim)
    query = pm1(rng, 1, dim)
    params = VectorParameters(dim, COUNT, dt, invert)
    enc = BinaryQuantizer.encode(data, params)
    got = np.asarray(enc.score_batch(enc.encode_query(query)))[0]
    want = np.asarray(pairwise(query, data, dt))[0]
    # Ascending quantized order must equal ascending (descending when
    # inverted) exact order (test_binary.rs:243-263, 304-324).
    want_order = stable_order(-want if invert else want)
    np.testing.assert_array_equal(stable_order(got), want_order)


@pytest.mark.parametrize("store_type", ["u8", "u128"])
def test_bq_save_load_roundtrip(tmp_path, rng, store_type):
    dim = 65
    data = pm1(rng, COUNT, dim)
    params = VectorParameters(dim, COUNT, DistanceType.L2, True)
    enc = BinaryQuantizer.encode(data, params, store_type=store_type)
    enc.save(tmp_path / "d.bin", tmp_path / "m.json")
    loaded = BinaryQuantizer.load(
        tmp_path / "d.bin", tmp_path / "m.json", params, store_type=store_type
    )
    q = pm1(rng, 2, dim)
    np.testing.assert_array_equal(
        np.asarray(enc.score_batch(enc.encode_query(q))),
        np.asarray(loaded.score_batch(loaded.encode_query(q))),
    )


def test_bq_storage_sizes():
    # Word-size tiers (encoded_vectors_binary.rs:99-116,152-159).
    assert bq_ops.storage_bytes(1, "u8") == 1
    assert bq_ops.storage_bytes(32, "u8") == 1 * 4  # 32 bits -> 1 u8 word? no:
    # dim=32 -> not >32 -> word=1 byte -> ceil(32/8)=4 bytes
    assert bq_ops.storage_bytes(33, "u8") == 8  # word=4B, ceil(33/32)=2 words
    assert bq_ops.storage_bytes(65, "u8") == 16  # word=8B, ceil(65/64)=2
    assert bq_ops.storage_bytes(129, "u8") == 32  # word=16B, ceil(129/128)=2
    assert bq_ops.storage_bytes(1, "u128") == 16
    assert bq_ops.storage_bytes(387, "u128") == 64


def test_bq_pack_layout_matches_reference_bit_order():
    # bit i of byte i//8 (little-endian) — encoded_vectors_binary.rs:199-207
    v = np.zeros((1, 9), np.float32)
    v[0, 0] = 1.0  # bit 0 -> byte 0 = 0b1
    v[0, 8] = 1.0  # bit 8 -> byte 1 = 0b1
    rows = bq_ops.pack_rows(v, bq_ops.storage_bytes(9, "u8"))
    assert rows[0, 0] == 1 and rows[0, 1] == 1


def test_bq_stop_condition(rng):
    data = pm1(rng, 1000, 64)
    params = VectorParameters(64, 1000, DistanceType.DOT, False)
    with pytest.raises(StoppedError):
        BinaryQuantizer.encode(
            data, params, stop_condition=lambda: True, batch_size=100
        )
