"""Product-quantization ops: chunking, batched nearest-centroid encode,
LUT build, and LUT scoring.

Batched re-design of quantization/src/encoded_vectors_pq.rs. The reference
encodes vectors on a condvar-ordered thread ring (encoded_vectors_pq.rs:168-226)
and scores with an SSE LUT-gather loop (rs:405-440); here encode is a batched
argmin over a distance tensor and scoring sums per-chunk LUT gathers on
device. Chunks are padded to a common width with zeros — zero pads in both
operands contribute 0 to every distance used here, so results are unchanged.
"""

from __future__ import annotations

from functools import partial
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import DistanceType

CENTROIDS_COUNT = 256  # encoded_vectors_pq.rs:25
CENTROIDS_COUNT4 = 16  # 4-bit (Quick-ADC style) extension — not in reference
KMEANS_SAMPLE_SIZE = 10_000  # rs:22
KMEANS_MAX_ITERATIONS = 100  # rs:23
KMEANS_ACCURACY = 1e-5  # rs:24
# Device layout, kept from the removed kernels' tiling so shapes are
# unchanged (a GPU-shaped layout is ROADMAP Design 4): corpus rows pad to
# ROW_ALIGN, the chunk axis to CHUNK_ALIGN.
ROW_ALIGN = 1024
CHUNK_ALIGN = 16


def get_vector_division(dim: int, chunk_size: int) -> List[Tuple[int, int]]:
    """Split [0, dim) into chunks of <= chunk_size
    (encoded_vectors_pq.rs:116-121)."""
    return [
        (i, min(i + chunk_size, dim)) for i in range(0, dim, max(1, chunk_size))
    ]


def chunk_tensor(
    data: np.ndarray, division: List[Tuple[int, int]]
) -> np.ndarray:
    """[B, dim] -> [m, B, dmax] with zero padding on ragged last chunk."""
    dmax = max(e - s for s, e in division)
    m = len(division)
    out = np.zeros((m, data.shape[0], dmax), dtype=np.float32)
    for ci, (s, e) in enumerate(division):
        out[ci, :, : e - s] = data[:, s:e]
    return out


def chunk_rows_device(x: jax.Array, division: List[Tuple[int, int]]) -> jax.Array:
    """Device-side ``chunk_tensor``: f32[B, dim] -> f32[m, B, dmax] with a
    pad + reshape instead of a host copy. Valid for the contiguous
    equal-width-except-ragged-tail divisions ``get_vector_division``
    produces; used on the OPQ encode path where rows are already on device
    (rotated) and bouncing through numpy would serialize the stream."""
    m = len(division)
    dmax = max(e - s for s, e in division)
    dim = division[-1][1]
    assert all(s == i * dmax for i, (s, e) in enumerate(division)), division
    x = jnp.pad(x, ((0, 0), (0, m * dmax - dim)))
    return jnp.transpose(jnp.reshape(x, (x.shape[0], m, dmax)), (1, 0, 2))


def centroids_to_chunks(
    centroids: np.ndarray, division: List[Tuple[int, int]]
) -> np.ndarray:
    """Full-dim centroids [k, dim] -> chunked [m, k, dmax] (zero-padded)."""
    return chunk_tensor(centroids, division)


def chunks_to_centroids(
    chunked: np.ndarray, division: List[Tuple[int, int]], dim: int
) -> np.ndarray:
    """Chunked centroids [m, k, dmax] -> full-dim [k, dim]."""
    k = chunked.shape[1]
    out = np.zeros((k, dim), dtype=np.float32)
    for ci, (s, e) in enumerate(division):
        out[:, s:e] = chunked[ci, :, : e - s]
    return out


@jax.jit
def _encode_group(x: jax.Array, c: jax.Array) -> jax.Array:
    """Nearest-centroid codes for a chunk group: f32[g, B, d], f32[g, k, d]
    -> u8[g, B]. Batched einsum + argmin (no per-chunk scan)."""
    x2 = jnp.sum(x * x, axis=2)[:, :, None]  # [g, B, 1]
    c2 = jnp.sum(c * c, axis=2)  # [g, k]
    xc = jnp.einsum("gbd,gkd->gbk", x, c, preferred_element_type=jnp.float32)
    d2 = x2 + c2[:, None, :] - 2.0 * xc
    return jnp.argmin(d2, axis=2).astype(jnp.uint8)  # first min


def encode_batch(x_chunks: jax.Array, c_chunks: jax.Array) -> jax.Array:
    """Nearest-centroid codes for a batch.

    x_chunks: f32[m, B, dmax], c_chunks: f32[m, k, dmax] -> u8[B, m].
    Per-chunk argmin of squared euclidean distance — PQ always uses the
    euclid metric for encoding regardless of the scoring distance
    (encoded_vectors_pq.rs:250-256). The chunk axis runs in balanced groups
    so the [g, B, k] distance tensor stays bounded and every group reuses
    one compiled program.
    """
    from .kmeans import group_size

    x_chunks = jnp.asarray(x_chunks, jnp.float32)
    c_chunks = jnp.asarray(c_chunks, jnp.float32)
    m, b, _ = x_chunks.shape
    k = c_chunks.shape[1]
    g = group_size(m, b, k)
    # Ragged tail group instead of pad-by-duplication: one extra compiled
    # shape beats copying the whole chunk tensor per call.
    parts = [
        _encode_group(x_chunks[i : i + g], c_chunks[i : i + g])
        for i in range(0, m, g)
    ]
    codes_mb = jnp.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
    return codes_mb.T


@partial(jax.jit, static_argnames=("distance_type", "invert"))
def build_lut(
    q_chunks: jax.Array,
    c_chunks: jax.Array,
    *,
    distance_type: DistanceType,
    invert: bool,
) -> jax.Array:
    """Per-query lookup table lut[Q, m, k]: exact distance from each query
    sub-vector to each centroid sub-vector (encoded_vectors_pq.rs:525-547),
    negated under ``invert``.

    HIGHEST matmul precision: a default-precision f32 dot may round its
    inputs (TF32 keeps about three decimal digits), which on data-scale
    entries perturbs each LUT cell — summed over m chunks that rivals
    residual-scale score deltas. The LUT build is a ~Q*m*k*dmax flop drop
    next to any scan, so true f32 here is free."""
    hp = jax.lax.Precision.HIGHEST
    if distance_type == DistanceType.DOT:
        lut = jnp.einsum(
            "mqd,mkd->mqk", q_chunks, c_chunks,
            preferred_element_type=jnp.float32, precision=hp,
        )
    elif distance_type == DistanceType.L1:
        lut = jnp.sum(
            jnp.abs(q_chunks[:, :, None, :] - c_chunks[:, None, :, :]), axis=-1
        )  # [m, Q, k]
    else:
        q2 = jnp.sum(q_chunks * q_chunks, axis=2)[:, :, None]  # [m, Q, 1]
        c2 = jnp.sum(c_chunks * c_chunks, axis=2)[:, None, :]  # [m, 1, k]
        qc = jnp.einsum(
            "mqd,mkd->mqk", q_chunks, c_chunks,
            preferred_element_type=jnp.float32, precision=hp,
        )
        lut = q2 + c2 - 2.0 * qc
    lut = jnp.moveaxis(lut, 0, 1)
    return -lut if invert else lut


@jax.jit
def score_lut_xla(lut: jax.Array, codes: jax.Array) -> jax.Array:
    """[Q, N] scores = sum over chunks of lut[q, m, codes[n, m]].

    Scans chunks, gathering a [Q, N] slice per chunk into an f32
    accumulator.
    """
    codes_mn = codes.T.astype(jnp.int32)  # [m, N]

    def body(acc, args):
        lut_m, codes_m = args  # [Q, k], [N]
        return acc + jnp.take(lut_m, codes_m, axis=1), None

    q = lut.shape[0]
    n = codes.shape[0]
    init = jnp.zeros((q, n), jnp.float32)
    acc, _ = jax.lax.scan(body, init, (jnp.moveaxis(lut, 1, 0), codes_mn))
    return acc


@jax.jit
def score_candidates_lut(
    lut: jax.Array, codes: jax.Array, cand: jax.Array
) -> jax.Array:
    """[Q, R] PQ scores against per-query candidate lists: gather candidate
    code rows, then take_along_axis into the LUT."""
    g = jnp.take(codes, cand, axis=0).astype(jnp.int32)  # [Q, R, m]
    picked = jnp.take_along_axis(
        lut, jnp.moveaxis(g, 1, 2), axis=2
    )  # [Q, m, R]
    return jnp.sum(picked, axis=1)


@partial(jax.jit, static_argnames=("distance_type", "invert"))
def centroid_distance_table(
    c_chunks: jax.Array, *, distance_type: DistanceType, invert: bool
) -> jax.Array:
    """cdist[m, k, k]: pairwise distance between centroids of each chunk —
    the batched form of the reference's decode-and-compare score_internal
    (encoded_vectors_pq.rs:566-593)."""

    if distance_type == DistanceType.DOT:
        cdist = jnp.einsum(
            "mad,mbd->mab", c_chunks, c_chunks,
            preferred_element_type=jnp.float32,
        )
    elif distance_type == DistanceType.L1:
        cdist = jnp.sum(
            jnp.abs(c_chunks[:, :, None, :] - c_chunks[:, None, :, :]), axis=-1
        )
    else:
        c2 = jnp.sum(c_chunks * c_chunks, axis=2)
        ab = jnp.einsum(
            "mad,mbd->mab", c_chunks, c_chunks,
            preferred_element_type=jnp.float32,
        )
        cdist = c2[:, :, None] + c2[:, None, :] - 2.0 * ab
    return -cdist if invert else cdist


@jax.jit
def score_internal_lut(
    cdist: jax.Array, codes_a: jax.Array, codes_b: jax.Array
) -> jax.Array:
    """[P] scores between stored code rows via the centroid-distance table.

    codes_a/b: u8[P, m]."""
    a = codes_a.astype(jnp.int32)  # [P, m]
    b = codes_b.astype(jnp.int32)
    m = cdist.shape[0]
    k = cdist.shape[1]
    chunk_ids = jnp.arange(m)[None, :]
    flat = cdist.reshape(-1)
    idx = (chunk_ids * k + a) * k + b  # [P, m]
    return jnp.sum(jnp.take(flat, idx), axis=1)
