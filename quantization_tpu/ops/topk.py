"""Top-k selection over device-resident score matrices.

The reference's serving loop keeps a bounded binary heap per query on the
host (ann_benchmark_data.rs:151-166). Here the score matrix never leaves
the device; selection is the last stage of every search.

``method`` is "exact" or "approx". Both run ``lax.top_k``:
``lax.approx_max_k`` lowers to an exact sort on GPUs (its approximate
lowering targets another accelerator), and on an H100 it measured no
faster than ``lax.top_k`` at [256, 1M] for k = 10 to 1000 (CHANGES.md).
So "approx" is accepted everywhere and is exact on this card;
``recall_target`` is accepted and unused.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

# Python float, not jnp.float32: a module-level device constant would
# initialize the JAX backend at import time (before the caller set
# platforms/flags). Weak typing keeps f32 semantics.
NEG_INF = float("-inf")

METHODS = ("exact", "approx")


@partial(jax.jit, static_argnames=("k",))
def topk_exact(scores: jax.Array, k: int) -> Tuple[jax.Array, jax.Array]:
    """Exact (scores[Q, k], indices[Q, k])."""
    n = scores.shape[-1]
    s, i = jax.lax.top_k(scores, min(k, n))
    return _pad_k(s, i, k, n)


def _pad_k(s, i, k, n):
    # Sentinel contract: when fewer than k candidates exist, missing slots
    # hold score -inf and index -1 — never a valid corpus id.
    got = s.shape[1]
    if got < k:
        s = jnp.pad(s, ((0, 0), (0, k - got)), constant_values=NEG_INF)
        i = jnp.pad(i, ((0, 0), (0, k - got)), constant_values=-1)
    return s, i.astype(jnp.int32)


def top_k(
    scores: jax.Array, k: int, method: str = "exact", recall_target=None
) -> Tuple[jax.Array, jax.Array]:
    """(scores[Q, k], indices[Q, k]); every method is exact (see the
    module docstring)."""
    if method not in METHODS:
        raise ValueError(f"unknown top-k method {method!r}")
    return topk_exact(scores, k)


# Corpus rows per block in blocked_topk: [256 queries, 1M rows] f32 scores
# is 1 GB of transient device memory — bounded regardless of corpus size.
BLOCK_ROWS = 1 << 20


def blocked_topk(
    score_block,
    count: int,
    k: int,
    method: str = "exact",
    block_rows: int = BLOCK_ROWS,
) -> Tuple[jax.Array, jax.Array]:
    """Exact-at-any-k selection with O(Q * block_rows) peak memory.

    ``score_block(b0, b1) -> f32[Q, b1-b0]`` scores one corpus slice.
    Blocks are scored + selected independently and merged with one final
    top-k — the device-resident analogue of the reference's per-point
    bounded heap (ann_benchmark_data.rs:151-166), which is exact at any k
    with bounded memory. All blocks are enqueued before any host sync (at
    most two compiled shapes: body + tail)."""
    parts_s, parts_i = [], []
    for b0 in range(0, count, block_rows):
        b1 = min(b0 + block_rows, count)
        s, i = top_k(score_block(b0, b1), min(k, b1 - b0), method=method)
        parts_s.append(s)
        parts_i.append(i + b0)
    s = jnp.concatenate(parts_s, axis=1)
    i = jnp.concatenate(parts_i, axis=1)
    kk = min(k, s.shape[1])
    ss, pos = jax.lax.top_k(s, kk)
    ii = jnp.take_along_axis(i, pos, axis=1)
    return _pad_k(ss, ii, k, count)
