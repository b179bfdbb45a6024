"""Top-k selection tests: blocked exact two-stage equals flat lax.top_k."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantization_tpu.ops.topk import top_k, topk_exact


@pytest.mark.parametrize("k", [1, 10, 40])
def test_approx_route_is_exact(rng, k):
    """method="approx" is accepted everywhere and selects exactly
    (ops/topk.py: approx_max_k is no faster than top_k on the GPU), so it
    returns the exact top-k, recall_target notwithstanding."""
    scores = jnp.asarray(rng.standard_normal((4, 3000)).astype(np.float32))
    ws, wi = topk_exact(scores, k)
    for rt in (None, 0.5, 0.99):
        s, i = top_k(scores, k, method="approx", recall_target=rt)
        np.testing.assert_array_equal(np.asarray(s), np.asarray(ws))
        np.testing.assert_array_equal(np.asarray(i), np.asarray(wi))
    jaxpr = jax.make_jaxpr(lambda x: top_k(x, k, method="approx"))(scores)
    assert "approx_top_k" not in str(jaxpr)


@pytest.mark.parametrize("n", [10, 2048, 5000, 10001])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_topk_exact_matches_flat(rng, n, k):
    scores = jnp.asarray(rng.standard_normal((3, n)).astype(np.float32))
    s, i = topk_exact(scores, k)
    s_ref, i_ref = jax.lax.top_k(scores, min(k, n))
    kk = min(k, n)
    np.testing.assert_array_equal(np.asarray(s)[:, :kk], np.asarray(s_ref))
    # indices may differ on exact ties; values gathered must match
    gathered = np.take_along_axis(np.asarray(scores), np.asarray(i)[:, :kk], 1)
    np.testing.assert_array_equal(gathered, np.asarray(s_ref))
    assert s.shape == (3, k) and i.shape == (3, k)


def test_topk_k_larger_than_n(rng):
    scores = jnp.asarray(rng.standard_normal((2, 5)).astype(np.float32))
    s, i = topk_exact(scores, 8)
    assert s.shape == (2, 8)
    assert np.all(np.isneginf(np.asarray(s)[:, 5:]))
    # missing-slot sentinel is -1 (the blocked and sharded merges share it),
    # never a valid corpus id like 0
    assert np.all(np.asarray(i)[:, 5:] == -1)


def test_topk_dispatch(rng):
    scores = jnp.asarray(rng.standard_normal((2, 300)).astype(np.float32))
    s, i = top_k(scores, 5, method="exact")
    assert s.shape == (2, 5)
    with pytest.raises(ValueError):
        top_k(scores, 5, method="bogus")


def test_blocked_topk_matches_flat(rng):
    from quantization_tpu.ops.topk import blocked_topk

    scores = jnp.asarray(rng.standard_normal((3, 1000)).astype(np.float32))
    want_s, want_i = topk_exact(scores, 7)

    def score_block(b0, b1):
        return scores[:, b0:b1]

    got_s, got_i = blocked_topk(score_block, 1000, 7, block_rows=128)
    np.testing.assert_array_equal(np.asarray(got_i), np.asarray(want_i))
    np.testing.assert_array_equal(np.asarray(got_s), np.asarray(want_s))


def test_blocked_topk_k_spans_blocks(rng):
    """k larger than a block: every block contributes its full slice."""
    from quantization_tpu.ops.topk import blocked_topk

    scores = jnp.asarray(rng.standard_normal((2, 300)).astype(np.float32))
    want_s, want_i = topk_exact(scores, 150)

    got_s, got_i = blocked_topk(
        lambda b0, b1: scores[:, b0:b1], 300, 150, block_rows=64
    )
    np.testing.assert_array_equal(np.asarray(got_i), np.asarray(want_i))


def test_blocked_topk_k_exceeds_count(rng):
    from quantization_tpu.ops.topk import blocked_topk

    scores = jnp.asarray(rng.standard_normal((2, 90)).astype(np.float32))
    got_s, got_i = blocked_topk(
        lambda b0, b1: scores[:, b0:b1], 90, 128, block_rows=32
    )
    assert got_s.shape == (2, 128)
    assert np.all(np.isneginf(np.asarray(got_s)[:, 90:]))
    assert np.all(np.asarray(got_i)[:, 90:] == -1)


def test_model_blocked_reroute_is_exact(rng, monkeypatch):
    """Past ops.topk.BLOCK_ROWS (shrunk here) a search scores and selects
    the corpus block by block — never a [Q, N] score matrix — and stays
    exact at a k wider than a block."""
    import quantization_tpu.ops.topk as topk_mod
    from quantization_tpu import (
        BinaryQuantizer,
        DistanceType,
        ProductQuantizer,
        ScalarQuantizerU8,
        VectorParameters,
    )

    n, dim, k = 333, 32, 96
    data = rng.random((n, dim), dtype=np.float32)
    queries = rng.random((2, dim), dtype=np.float32)
    params = VectorParameters(dim, n, DistanceType.DOT, False)
    for enc in (
        ScalarQuantizerU8.encode(data, params),
        BinaryQuantizer.encode(data, params),
        ProductQuantizer.encode(data, params, chunk_size=4),
    ):
        eq = enc.encode_query(queries)
        want = np.asarray(enc.score_batch(eq))
        monkeypatch.setattr(topk_mod, "BLOCK_ROWS", 100)
        s, i = enc.top_k(eq, k)
        monkeypatch.undo()
        exact = -np.sort(-want, axis=1)[:, :k]
        np.testing.assert_allclose(s, exact, rtol=1e-6)
        np.testing.assert_allclose(
            np.take_along_axis(want, np.asarray(i), axis=1), s, rtol=1e-6
        )
