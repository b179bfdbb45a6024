"""Checks that only mean something on a GPU: what the compiler makes of
the int8 score and whether it stays exact. They skip elsewhere (the
``gpu`` fixture in conftest.py); on a GPU machine run
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantization_tpu.ops import sq as sq_ops

pytestmark = pytest.mark.gpu


def test_int_dot_is_an_exact_integer_gemm(gpu):
    # s8 x s8 -> s32 must lower to an integer GEMM (cuBLAS on an H100)
    # and stay exact past 2^24, where TF32 or an f32 upcast would round.
    rng = np.random.default_rng(0)
    qc = rng.integers(110, 128, (256, 1536), dtype=np.int8)
    cc = rng.integers(0, 128, (4096, 1536), dtype=np.int8)
    got = np.asarray(sq_ops.int_dot(jnp.asarray(qc), jnp.asarray(cc)))
    want = qc.astype(np.int64) @ cc.astype(np.int64).T
    np.testing.assert_array_equal(got.astype(np.int64), want)
    hlo = jax.jit(sq_ops.int_dot).lower(
        jnp.asarray(qc), jnp.asarray(cc)).compile().as_text()
    assert "s32[256,4096]" in hlo and "f32[256,4096]" not in hlo


def test_default_matmul_is_not_the_oracle(gpu):
    # The reason the oracle pins HIGHEST: at default precision an f32
    # matmul on this card rounds its inputs (TF32).
    from quantization_tpu.core.distances import pairwise_score
    from quantization_tpu.core.types import DistanceType

    rng = np.random.default_rng(1)
    q = rng.standard_normal((64, 1024)).astype(np.float32)
    x = rng.standard_normal((2048, 1024)).astype(np.float32)
    exact = q.astype(np.float64) @ x.astype(np.float64).T
    hi = np.asarray(pairwise_score(q, x, DistanceType.DOT, False))
    default = np.asarray(jnp.asarray(q) @ jnp.asarray(x).T)
    assert np.max(np.abs(hi - exact)) < np.max(np.abs(default - exact))
