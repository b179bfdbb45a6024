"""The exact f32 oracle (core/distances.py) against numpy float64: the
DOT and L2 matmuls are pinned to HIGHEST precision, so on any backend the
oracle is within f32 rounding of the float64 truth — a default-precision
matmul could run in TF32 (about three decimal digits) and judge recall
against a lower-precision reference."""

import numpy as np
import pytest

from quantization_tpu.core.distances import pairwise_score
from quantization_tpu.core.types import DistanceType


def _float64(queries, data, dt):
    q, x = queries.astype(np.float64), data.astype(np.float64)
    if dt == DistanceType.DOT:
        return q @ x.T
    if dt == DistanceType.L2:
        return ((q[:, None, :] - x[None, :, :]) ** 2).sum(axis=2)
    return np.abs(q[:, None, :] - x[None, :, :]).sum(axis=2)


@pytest.mark.parametrize("dt", [DistanceType.DOT, DistanceType.L2, DistanceType.L1])
def test_oracle_matches_float64(rng, dt):
    dim = 768
    data = rng.standard_normal((300, dim)).astype(np.float32)
    queries = rng.standard_normal((7, dim)).astype(np.float32)
    got = np.asarray(pairwise_score(queries, data, dt, False))
    want = _float64(queries, data, dt)
    # f32 accumulation of dim products: error <= dim ulps of the sum of
    # magnitudes; TF32 inputs would be ~2^-11 relative, far outside.
    mag = _float64(np.abs(queries), np.abs(data), DistanceType.DOT)
    if dt == DistanceType.L2:
        mag = 2 * mag + (queries.astype(np.float64) ** 2).sum(1)[:, None] + (
            data.astype(np.float64) ** 2).sum(1)[None, :]
    elif dt == DistanceType.L1:
        mag = want
    assert np.all(np.abs(got - want) <= dim * 2.0 ** -23 * mag)


def test_oracle_dot_is_highest_precision():
    import jax

    jaxpr = jax.make_jaxpr(
        lambda q, x: pairwise_score(q, x, DistanceType.DOT, False)
    )(np.ones((2, 8), np.float32), np.ones((3, 8), np.float32))
    assert "HIGHEST" in str(jaxpr)
