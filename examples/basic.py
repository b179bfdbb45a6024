"""Basic smoke demo — the JAX port of demos/src/basic.rs:11-50.

Encode 128 random 64-d vectors with the scalar u8 quantizer and assert every
quantized dot score is within dim*0.1 of the exact value, for both the
query path and the internal (stored-vs-stored) path.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from quantization_tpu import DistanceType, ScalarQuantizerU8, VectorParameters
from quantization_tpu.core.distances import pairwise_score


def main():
    count, dim = 128, 64
    rng = np.random.default_rng(42)
    data = rng.random((count, dim), dtype=np.float32)
    query = rng.random((dim,), dtype=np.float32)

    params = VectorParameters(dim, count, DistanceType.DOT, invert=False)
    encoded = ScalarQuantizerU8.encode(data, params)

    eq = encoded.encode_query(query)
    scores = np.asarray(encoded.score_batch(eq))[0]
    exact = np.asarray(pairwise_score(query[None], data, DistanceType.DOT, False))[0]
    assert np.all(np.abs(scores - exact) < dim * 0.1), "query path out of bounds"

    ids = np.arange(count)
    internal = np.asarray(
        encoded.score_internal_batch(np.zeros(count, np.int64), ids)
    )
    exact0 = np.asarray(
        pairwise_score(data[:1], data, DistanceType.DOT, False)
    )[0]
    assert np.all(np.abs(internal - exact0) < dim * 0.1), "internal path out of bounds"

    print(f"ok: {count}x{dim} u8 dot scores within {dim * 0.1}")
    print(f"   max query error    = {np.abs(scores - exact).max():.4f}")
    print(f"   max internal error = {np.abs(internal - exact0).max():.4f}")


if __name__ == "__main__":
    main()
