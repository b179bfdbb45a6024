"""Exact f32 distance oracle, batched (the batch form of the reference's
scalar ``DistanceType::distance`` at encoded_vectors.rs:37-45).

Everything here is pure jnp and jit-friendly. The *batch* is the primitive:
``pairwise(queries[Q, D], corpus[N, D])`` produces the full score matrix in one
XLA op, where the reference computes one (a, b) pair per call.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .types import DistanceType


def distance(a: jax.Array, b: jax.Array, distance_type: DistanceType) -> jax.Array:
    """Exact distance over the last axis (broadcasts leading axes).

    Semantics match reference ``DistanceType::distance``
    (encoded_vectors.rs:37-45): DOT is the raw dot product (a similarity),
    L1/L2 are distances; L2 is the *squared* euclidean distance.
    """
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    if distance_type == DistanceType.DOT:
        return jnp.sum(a * b, axis=-1)
    if distance_type == DistanceType.L1:
        return jnp.sum(jnp.abs(a - b), axis=-1)
    if distance_type == DistanceType.L2:
        d = a - b
        return jnp.sum(d * d, axis=-1)
    raise ValueError(f"unknown distance type {distance_type}")


def pairwise(
    queries: jax.Array, corpus: jax.Array, distance_type: DistanceType
) -> jax.Array:
    """Exact [Q, N] distance matrix between queries[Q, D] and corpus[N, D].

    DOT and L2 are one matmul (L2 by norm expansion), pinned to HIGHEST
    precision: this is the exact reference, and a default-precision f32
    matmul may run in TF32 (about three decimal digits). L1 is computed in
    N-tiles to avoid materializing [Q, N, D].
    """
    queries = jnp.asarray(queries, jnp.float32)
    corpus = jnp.asarray(corpus, jnp.float32)
    if distance_type in (DistanceType.DOT, DistanceType.L2):
        dots = jnp.matmul(
            queries, corpus.T, precision=jax.lax.Precision.HIGHEST
        )
    if distance_type == DistanceType.DOT:
        return dots
    if distance_type == DistanceType.L2:
        qq = jnp.sum(queries * queries, axis=-1, keepdims=True)  # [Q, 1]
        nn = jnp.sum(corpus * corpus, axis=-1)  # [N]
        return qq + nn[None, :] - 2.0 * dots
    if distance_type == DistanceType.L1:
        # Tile over N so peak memory is Q * TILE * D.
        tile = 1024
        n = corpus.shape[0]
        pad = (-n) % tile
        corpus_p = jnp.pad(corpus, ((0, pad), (0, 0)))
        tiles = corpus_p.reshape(-1, tile, corpus.shape[1])

        def body(c_tile):
            return jnp.sum(
                jnp.abs(queries[:, None, :] - c_tile[None, :, :]), axis=-1
            )  # [Q, tile]

        out = jax.lax.map(body, tiles)  # [n_tiles, Q, tile]
        out = jnp.moveaxis(out, 0, 1).reshape(queries.shape[0], -1)
        return out[:, :n]
    raise ValueError(f"unknown distance type {distance_type}")


def score(
    a: jax.Array, b: jax.Array, distance_type: DistanceType, invert: bool
) -> jax.Array:
    """Exact score with the library's sign convention (invert => negate)."""
    d = distance(a, b, distance_type)
    return -d if invert else d


def pairwise_score(
    queries: jax.Array, corpus: jax.Array, distance_type: DistanceType, invert: bool
) -> jax.Array:
    d = pairwise(queries, corpus, distance_type)
    return -d if invert else d
