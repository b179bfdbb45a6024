"""Scalar (u8) quantization ops: affine codec + batched integer scoring.

Batched re-design of the reference SQ codec/kernels
(quantization/src/encoded_vectors_u8.rs + cpp/{avx2,sse,neon}.c):

  * codes live in [0, 127] (alpha = (max-min)/127, offset = min —
    encoded_vectors_u8.rs:228-232), so they fit **int8** and dot products run
    as one int8 x int8 -> int32 matmul with exact integer accumulation — the
    batched replacement for the `maddubs` AVX2 kernel (cpp/avx2.c:25-63).
  * layout is SoA: codes int8[N, D_pad] + per-vector f32 correction offsets[N]
    (vs the reference's per-row inline f32 prefix, encoded_vectors_u8.rs:78-116).
  * D is padded in two steps: pad_code to the reference's 16-aligned
    actual_dim (same placeholder semantics as encoded_vectors_u8.rs:84-93 —
    the pad encodes real value 0.0 for DOT and `offset` i.e. code 0 for
    L1/L2, so pads cancel exactly in scores and voffsets match the
    reference bit-for-bit), then zeros to a multiple of 128 columns (zero
    columns on both operands contribute exactly 0 to every kernel and sum).

Score contract (encoded_vectors_u8.rs:145-158):
    score = multiplier * int_kernel(Q, V) + query_offset + vector_offset
with multiplier = alpha^2 (DOT), alpha (L1), -2*alpha^2 (L2), negated when
``invert`` is set; DOT and L2 share the integer dot kernel, L1 uses the
sum-of-absolute-differences kernel.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import DistanceType

ALIGNMENT = 16  # reference row alignment (encoded_vectors_u8.rs:12)
# In-memory layout, kept from the removed kernels' tiling so saved
# files and shapes are unchanged (a GPU-shaped layout is ROADMAP Design 4):
# code columns pad to a multiple of LANE, corpus rows to ROW_ALIGN.
LANE = 128
ROW_ALIGN = 512
CODE_MAX = 127.0


def actual_dim(dim: int, alignment: int = ALIGNMENT) -> int:
    """dim rounded up to the reference's 16-byte alignment (get_actual_dim,
    encoded_vectors_u8.rs:257-259). This is the on-disk row width; the
    in-memory layout zero-pads further to the 128 lane width (``LANE``),
    which is score-neutral: lanes in [actual_dim, LANE-aligned) hold code 0
    on both query and corpus sides, contributing exactly 0 to the integer
    dot kernel and 0 to every offset sum."""
    return dim + (alignment - dim % alignment) % alignment


def lane_dim(dim: int) -> int:
    """The in-memory column count: actual_dim rounded up to the lane width."""
    a = actual_dim(dim)
    return a + (-a) % LANE


def alpha_offset_from_min_max(mn: float, mx: float) -> Tuple[float, float]:
    """(alpha, offset) of the affine code map (encoded_vectors_u8.rs:228-232).

    alpha is clamped away from zero so constant data encodes to code 0
    instead of NaN.
    """
    alpha = (mx - mn) / CODE_MAX
    if not np.isfinite(alpha) or alpha <= 0.0:
        alpha = 1.0
    return float(alpha), float(mn)


def multiplier_for(distance_type: DistanceType, invert: bool, alpha: float) -> float:
    """Scalar applied to the raw integer kernel output
    (encoded_vectors_u8.rs:119-128)."""
    if distance_type == DistanceType.DOT:
        m = alpha * alpha
    elif distance_type == DistanceType.L1:
        m = alpha
    else:  # L2
        m = -2.0 * alpha * alpha
    return -m if invert else m


def _inv_alpha(alpha: float) -> float:
    """f32 reciprocal for the device quantizer. XLA's f32 divide is not
    correctly rounded (measured: reciprocal+Newton on CPU even for traced
    divisors), so IEEE-exact parity with the reference's `(v-off)/alpha`
    is unattainable on the device path regardless — use the explicit
    reciprocal multiply, which XLA folds a static divisor into anyway.
    Consequence: device codes can differ from the reference's by one at
    exact quantization boundaries (probability ~2^-23 per element on
    continuous data). The native C++ encoder (native/qtpu_native.cpp) does
    true IEEE division and is the byte-exact reference-interop path."""
    return float(np.float32(1.0) / np.float32(alpha))


def _f32_to_code(x: jax.Array, alpha: float, offset: float) -> jax.Array:
    """clamp((x-offset)/alpha, 0, 127) truncated toward zero — the behavior
    of the reference's `as u8` cast (encoded_vectors_u8.rs:234-237), with the
    division realized as multiply-by-f32-reciprocal (see _inv_alpha)."""
    q = (x - offset) * _inv_alpha(alpha)
    q = jnp.clip(q, 0.0, CODE_MAX)
    q = jnp.where(jnp.isnan(q), 0.0, q)
    return jnp.floor(q)


def pad_code(distance_type: DistanceType, alpha: float, offset: float) -> int:
    """Code value used for lane padding (encoded_vectors_u8.rs:84-93):
    DOT pads with the code of real value 0.0; L1/L2 pad with the code of
    `offset`, which is always 0. Host-computed with true IEEE division, so
    it matches the reference's f32_to_u8 exactly."""
    if distance_type == DistanceType.DOT:
        q = (np.float32(0.0) - np.float32(offset)) / np.float32(alpha)
        q = min(max(q, 0.0), CODE_MAX)
        if np.isnan(q):
            q = 0.0
        return int(q)
    return 0


@partial(
    jax.jit,
    static_argnames=("alpha", "offset", "distance_type", "invert", "dpad", "lane"),
)
def quantize_batch(
    x: jax.Array,
    *,
    alpha: float,
    offset: float,
    distance_type: DistanceType,
    invert: bool,
    dpad: int,
    lane: int = None,
) -> Tuple[jax.Array, jax.Array]:
    """Encode a [B, dim] float32 batch -> (codes int8[B, lane], voffset f32[B]).

    Implements the per-vector hot loop of encoded_vectors_u8.rs:73-118 as one
    fused device op: quantize, pad with ``pad_code`` to the reference's
    16-aligned ``dpad``, zero-pad to ``lane`` columns, and compute the
    per-vector correction term (encoded_vectors_u8.rs:94-109) over the
    dpad width exactly as the reference does — the zero columns beyond
    dpad contribute 0 to every sum, so voffsets match the reference
    bit-for-bit.
    """
    b, dim = x.shape
    if lane is None:
        lane = dpad
    codes_f = _f32_to_code(x.astype(jnp.float32), alpha, offset)
    if dpad > dim:
        pc = pad_code(distance_type, alpha, offset)
        pad = jnp.full((b, dpad - dim), float(pc), jnp.float32)
        codes_f = jnp.concatenate([codes_f, pad], axis=1)
    if distance_type == DistanceType.DOT:
        voff = dpad * offset * offset + jnp.sum(codes_f, axis=1) * (alpha * offset)
    elif distance_type == DistanceType.L1:
        voff = jnp.zeros((b,), jnp.float32)
    else:  # L2
        voff = dpad * offset * offset + jnp.sum(codes_f * codes_f, axis=1) * (
            alpha * alpha
        )
    if invert:
        voff = -voff
    if lane > dpad:
        codes_f = jnp.concatenate(
            [codes_f, jnp.zeros((b, lane - dpad), jnp.float32)], axis=1
        )
    return codes_f.astype(jnp.int8), voff.astype(jnp.float32)


@partial(
    jax.jit,
    static_argnames=("alpha", "offset", "distance_type", "invert", "dpad", "lane"),
)
def encode_query_batch(
    q: jax.Array,
    *,
    alpha: float,
    offset: float,
    distance_type: DistanceType,
    invert: bool,
    dpad: int,
    lane: int = None,
) -> Tuple[jax.Array, jax.Array]:
    """Quantize queries exactly like data (encoded_vectors_u8.rs:290-329).

    The query offset term is Sum(Q)*alpha*offset for DOT and
    Sum(Q^2)*alpha^2 for L2 (zero for L1), negated under invert. Padding
    mirrors quantize_batch: pad_code to the 16-aligned dpad, zeros to lane.
    """
    b, dim = q.shape
    if lane is None:
        lane = dpad
    codes_f = _f32_to_code(q.astype(jnp.float32), alpha, offset)
    if dpad > dim:
        pc = pad_code(distance_type, alpha, offset)
        pad = jnp.full((b, dpad - dim), float(pc), jnp.float32)
        codes_f = jnp.concatenate([codes_f, pad], axis=1)
    if distance_type == DistanceType.DOT:
        qoff = jnp.sum(codes_f, axis=1) * (alpha * offset)
    elif distance_type == DistanceType.L1:
        qoff = jnp.zeros((b,), jnp.float32)
    else:  # L2
        qoff = jnp.sum(codes_f * codes_f, axis=1) * (alpha * alpha)
    if invert:
        qoff = -qoff
    if lane > dpad:
        codes_f = jnp.concatenate(
            [codes_f, jnp.zeros((b, lane - dpad), jnp.float32)], axis=1
        )
    return codes_f.astype(jnp.int8), qoff.astype(jnp.float32)


# ---------------------------------------------------------------------------
# Integer kernels.
# ---------------------------------------------------------------------------


def int_dot(qcodes: jax.Array, codes: jax.Array) -> jax.Array:
    """[Q, N] exact int32 dot between int8 code matrices — the matmul form
    of impl_score_dot_avx (cpp/avx2.c:25-63). An s8 x s8 -> s32 dot_general
    accumulates in integers, so it is exact at any D (TF32 or an f32
    upcast would round sums past 2^24)."""
    return jax.lax.dot_general(
        qcodes,
        codes,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )


def int_l1(qcodes: jax.Array, codes: jax.Array, tile: int = 2048) -> jax.Array:
    """[Q, N] exact int32 sum-of-absolute-differences, tiled over N — the
    elementwise form of impl_score_l1_avx (cpp/avx2.c:65-122).

    Tiling bounds peak memory at Q * tile * D without materializing
    [Q, N, D].
    """
    n = codes.shape[0]
    pad = (-n) % tile
    codes_p = jnp.pad(codes, ((0, pad), (0, 0)))
    tiles = codes_p.reshape(-1, tile, codes.shape[1])
    q32 = qcodes.astype(jnp.int32)

    def body(c_tile):
        d = jnp.abs(q32[:, None, :] - c_tile.astype(jnp.int32)[None, :, :])
        return jnp.sum(d, axis=-1)  # [Q, tile]

    out = jax.lax.map(body, tiles)  # [nt, Q, tile]
    out = jnp.moveaxis(out, 0, 1).reshape(qcodes.shape[0], -1)
    return out[:, :n]


@partial(jax.jit, static_argnames=("distance_type",))
def score_batch_xla(
    qcodes: jax.Array,
    qoff: jax.Array,
    codes: jax.Array,
    voff: jax.Array,
    multiplier: float,
    *,
    distance_type: DistanceType,
) -> jax.Array:
    """[Q, N] scores: multiplier * kernel + qoff + voff
    (encoded_vectors_u8.rs:145-158). DOT and L2 share the dot kernel.
    ``multiplier`` is a scalar, or per-query [Q] / [Q, 1] (the residual-IVF
    query path quantizes each query with its own scale)."""
    if distance_type == DistanceType.L1:
        raw = int_l1(qcodes, codes)
    else:
        raw = int_dot(qcodes, codes)
    m = jnp.asarray(multiplier, jnp.float32).reshape(-1, 1)
    return m * raw.astype(jnp.float32) + qoff[:, None] + voff[None, :]


@partial(jax.jit, static_argnames=("distance_type",))
def score_candidates_xla(
    qcodes: jax.Array,  # int8 [Q, D]
    qoff: jax.Array,  # f32 [Q]
    codes: jax.Array,  # int8 [N, D]
    voff: jax.Array,  # f32 [N]
    cand: jax.Array,  # int32 [Q, R] per-query candidate ids
    multiplier: jax.Array,
    *,
    distance_type: DistanceType,
) -> jax.Array:
    """[Q, R] scores against per-query candidate lists (two-stage rescore)."""
    return _score_gathered(
        qcodes,
        qoff,
        jnp.take(codes, cand, axis=0),  # [Q, R, D]
        jnp.take(voff, cand),  # [Q, R]
        multiplier,
        distance_type=distance_type,
    )


@partial(jax.jit, static_argnames=("distance_type",))
def _score_gathered(
    qcodes, qoff, g, goff, multiplier, *, distance_type: DistanceType
) -> jax.Array:
    if distance_type == DistanceType.L1:
        raw = jnp.sum(
            jnp.abs(qcodes.astype(jnp.int32)[:, None, :] - g.astype(jnp.int32)),
            axis=-1,
        )
    else:
        raw = jax.lax.dot_general(
            qcodes,
            g,
            dimension_numbers=(((1,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.int32,
        )
    return multiplier * raw.astype(jnp.float32) + qoff[:, None] + goff


@partial(jax.jit, static_argnames=("distance_type",))
def score_internal_batch_xla(
    codes_a: jax.Array,
    voff_a: jax.Array,
    codes_b: jax.Array,
    voff_b: jax.Array,
    multiplier: float,
    diff: float,
    *,
    distance_type: DistanceType,
) -> jax.Array:
    """[P] stored-vs-stored scores (encoded_vectors_u8.rs:386-453):
    multiplier * kernel + off_a + off_b - diff, where
    diff = actual_dim * offset^2 (sign-flipped under invert) removes the
    double-counted constant."""
    a32 = codes_a.astype(jnp.int32)
    b32 = codes_b.astype(jnp.int32)
    if distance_type == DistanceType.L1:
        raw = jnp.sum(jnp.abs(a32 - b32), axis=-1)
    else:
        raw = jnp.sum(a32 * b32, axis=-1)
    return multiplier * raw.astype(jnp.float32) + voff_a + voff_b - diff
