"""Binary quantization ops: sign-bit packing + XOR-popcount Hamming scoring.

Batched re-design of quantization/src/encoded_vectors_binary.rs and the
xor-popcnt kernels (cpp/sse.c:49-106, cpp/neon.c:26-67):

  * storage is bit-packed, little-endian bit order within bytes and
    little-endian bytes within words — byte-identical to the reference's
    packed rows (encoded_vectors_binary.rs:193-208), 32x smaller than f32.
  * on device the codes live in **bit-plane layout**: uint32[W, N] with the
    big corpus axis N minor. Scoring is XOR + ``lax.population_count`` +
    accumulate over words — the batched replacement for `_mm_popcnt_u64`
    loops.
  * zero bits beyond ``dim`` are zero in both operands, so padding never
    contributes to the XOR count (same invariant as the reference,
    encoded_vectors_binary.rs:36-38).

Metric mapping from the XOR count x with true dimension d
(encoded_vectors_binary.rs:219-253):
    DOT:    (d - x) - x = d - 2x      (invert: 2x - d)
    L1/L2:  x - (d - x) = 2x - d      (invert: d - 2x)
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import ArgumentsError, DistanceType

# Device layout, kept from the removed kernels' tiling so shapes are
# unchanged (a GPU-shaped layout is ROADMAP Design 4): the plane-word axis
# pads to WORD_ALIGN, the corpus axis to ROW_ALIGN (single device) or
# SHARD_ROW_ALIGN per shard (sharded engines).
WORD_ALIGN = 8
ROW_ALIGN = 2048
SHARD_ROW_ALIGN = 512


def storage_bytes(dim: int, store_type: str = "u128") -> int:
    """Bytes per packed row, matching the reference's word-size tiers.

    ``u8`` tier (encoded_vectors_binary.rs:99-116): word size escalates with
    dim (1/4/8/16 bytes); ``u128`` (rs:152-159): always 16-byte words.
    """
    if store_type == "u8":
        if dim > 128:
            word = 16
        elif dim > 64:
            word = 8
        elif dim > 32:
            word = 4
        else:
            word = 1
    elif store_type == "u128":
        word = 16
    else:
        raise ArgumentsError(f"unknown bits store type {store_type!r}")
    bits = 8 * word
    words = dim // bits + (1 if dim % bits else 0)
    return words * word


def pack_rows(data: np.ndarray, row_bytes: int) -> np.ndarray:
    """Sign-pack a [B, dim] f32 batch into [B, row_bytes] uint8 rows
    (bit i of byte i//8 set iff value > 0 — encoded_vectors_binary.rs:199-207)."""
    bits = (np.asarray(data) > 0.0).astype(np.uint8)
    packed = np.packbits(bits, axis=1, bitorder="little")
    if packed.shape[1] < row_bytes:
        packed = np.pad(packed, ((0, 0), (0, row_bytes - packed.shape[1])))
    return packed


def rows_to_planes(rows: np.ndarray) -> np.ndarray:
    """[N, B] packed bytes -> bit-plane uint32[W, N] device layout."""
    n, b = rows.shape
    pad = (-b) % 4
    if pad:
        rows = np.pad(rows, ((0, 0), (0, pad)))
    # The u32 view needs a contiguous last axis; callers may pass a
    # non-contiguous view (a memmap slice, a transposed array).
    rows = np.ascontiguousarray(rows)
    words = rows.reshape(n, -1, 4).view(np.uint32).reshape(n, -1)  # LE combine
    return np.ascontiguousarray(words.T)


def planes_to_rows(planes: np.ndarray, row_bytes: int) -> np.ndarray:
    """Invert rows_to_planes back to [N, row_bytes] uint8 rows."""
    words = np.ascontiguousarray(planes.T)  # [N, W] uint32
    rows = words.view(np.uint8).reshape(words.shape[0], -1)
    return rows[:, :row_bytes]


@partial(jax.jit, static_argnames=("distance_type", "invert", "dim", "tile"))
def score_batch_xla(
    qplanes: jax.Array,
    planes: jax.Array,
    *,
    distance_type: DistanceType,
    invert: bool,
    dim: int,
    tile: int = 8192,
) -> jax.Array:
    """[Q, N] binary scores: tiled XOR + population_count + plane reduce.

    ``qplanes`` is uint32[Q, W]; ``planes`` is uint32[W, N]. Tiles over N so
    peak memory is Q * W * tile.
    """
    w, n = planes.shape
    if w == 0 or n == 0:
        xor = jnp.zeros((qplanes.shape[0], n), jnp.int32)
        return metric_from_xor(
            xor, distance_type=distance_type, invert=invert, dim=dim
        )
    pad = (-n) % tile
    planes_p = jnp.pad(planes, ((0, 0), (0, pad)))
    tiles = jnp.moveaxis(planes_p.reshape(w, -1, tile), 1, 0)  # [nt, W, tile]

    def body(p_tile):
        x = jnp.bitwise_xor(qplanes[:, :, None], p_tile[None, :, :])
        return jnp.sum(
            jax.lax.population_count(x).astype(jnp.int32), axis=1
        )  # [Q, tile]

    xor = jax.lax.map(body, tiles)  # [nt, Q, tile]
    xor = jnp.moveaxis(xor, 0, 1).reshape(qplanes.shape[0], -1)[:, :n]
    return metric_from_xor(
        xor, distance_type=distance_type, invert=invert, dim=dim
    )


def score_affine_xla(
    qs: jax.Array,  # int8 [Q, Dp] quantized query values (0 on pads)
    mult: jax.Array,  # f32 scalar or per-query [Q] / [Q, 1] multiplier
    qb: jax.Array,  # f32 [Q, 1] per-query bias
    planes: jax.Array,  # uint32 [W, N]
    *,
    tile: int = 1 << 15,
) -> jax.Array:
    """[Q, N] affine bit scores ``mult * (qs . bits) + qb`` — the
    residual-BQ scan (asymmetric quantized-VALUE queries against unpacked
    0/1 corpus bits; models/ivf.py _ResidualQueryBQ). Tiles over N: the
    unpack materializes a [Dp, tile] int8 transient per step."""
    w, n = planes.shape
    dp = w * 32
    if w == 0 or n == 0:
        return jnp.broadcast_to(qb.astype(jnp.float32), (qs.shape[0], n))
    pad = (-n) % tile
    planes_p = jnp.pad(planes, ((0, 0), (0, pad)))
    tiles = jnp.moveaxis(planes_p.reshape(w, -1, tile), 1, 0)

    def body(p_tile):
        rep = jnp.repeat(p_tile.astype(jnp.int32), 32, axis=0)
        shifts = (jnp.arange(dp, dtype=jnp.int32) % 32)[:, None]
        bits = jnp.bitwise_and(
            jax.lax.shift_right_logical(rep, shifts), 1
        ).astype(jnp.int8)
        return jax.lax.dot_general(
            qs,
            bits,
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )

    acc = jax.lax.map(body, tiles)  # [nt, Q, tile]
    acc = jnp.moveaxis(acc, 0, 1).reshape(qs.shape[0], -1)[:, :n]
    m = jnp.asarray(mult, jnp.float32).reshape(-1, 1)
    return m * acc.astype(jnp.float32) + qb.astype(jnp.float32)


@partial(jax.jit, static_argnames=("distance_type", "invert", "dim"))
def score_candidates_xla(
    qplanes: jax.Array,  # uint32 [Q, W]
    planes: jax.Array,  # uint32 [W, N]
    cand: jax.Array,  # int32 [Q, R]
    *,
    distance_type: DistanceType,
    invert: bool,
    dim: int,
) -> jax.Array:
    """[Q, R] binary scores against per-query candidate lists."""
    g = jnp.take(planes, cand, axis=1)  # [W, Q, R]
    x = jnp.bitwise_xor(g, qplanes.T[:, :, None])
    xor = jnp.sum(jax.lax.population_count(x).astype(jnp.int32), axis=0)
    return metric_from_xor(
        xor, distance_type=distance_type, invert=invert, dim=dim
    )


def metric_from_xor(
    xor: jax.Array, *, distance_type: DistanceType, invert: bool, dim: int
) -> jax.Array:
    """Map XOR counts to the score contract
    (truth table at encoded_vectors_binary.rs:221-252)."""
    x = xor.astype(jnp.float32)
    d = jnp.float32(dim)
    if distance_type == DistanceType.DOT:
        return x + x - d if invert else d - x - x
    return d - x - x if invert else x + x - d
