"""Two-stage retrieval: coarse quantized scan -> candidate rescoring.

The Qdrant-style serving pattern the reference enables by exposing all
quantizers over one trait (SURVEY.md §7 step 3): a cheap coarse scorer (BQ
Hamming, typically) produces an oversampled candidate set, and a finer scorer
(SQ, PQ, or exact f32) re-ranks just those candidates. Both stages run on
device; only the final (scores, indices) land on host.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.interface import EncodedVectors
from ..core.types import ArgumentsError


class ExactRescorer:
    """f32 rescoring stage backed by the original vectors.

    ``host_resident=False`` (default) keeps the corpus in device memory —
    right for corpora that fit (1M x 768 f32 is ~3GB). ``host_resident=True``
    keeps it on the host (accepts a numpy array OR an np.memmap, so a
    10M x 1536 corpus — 61GB — rescores from disk-backed memory):
    per call only the gathered [Q, R, D] candidate rows cross the link.
    For multi-chip HBM residency use
    ``parallel.sharded.ShardedExactRescorer`` instead."""

    def __init__(
        self,
        data: np.ndarray,
        distance_type,
        invert: bool,
        host_resident: bool = False,
    ):
        from ..core.distances import pairwise_score

        self._host = host_resident
        if host_resident:
            self._data = np.asarray(data)  # no copy for memmaps/f32 arrays
        else:
            self._data = jnp.asarray(data, jnp.float32)
        self._dt = distance_type
        self._invert = invert
        self._pairwise_score = pairwise_score

    def encode_query(self, queries):
        q = jnp.asarray(queries, jnp.float32)
        return q[None, :] if q.ndim == 1 else q

    def score_points(self, equery, ids) -> jax.Array:
        if self._host:
            # Clip like the device path's jnp.take does: a -1 padding id
            # must not wrap to the last row via numpy negative indexing.
            idx = np.clip(
                np.asarray(ids, np.int64), 0, self._data.shape[0] - 1
            )
            sub = jnp.asarray(self._data[idx], jnp.float32)
        else:
            sub = jnp.take(self._data, jnp.asarray(ids, jnp.int32), axis=0)
        return self._pairwise_score(equery, sub, self._dt, self._invert)

    def score_candidates(self, equery, cand) -> jax.Array:
        from ..core.distances import score as _score

        if self._host:
            # Host gather (numpy fancy-index works on memmaps too), then a
            # single [Q, R, D] upload — HBM never holds the corpus. Clip to
            # match the device path's jnp.take semantics on padding ids.
            idx = np.clip(
                np.asarray(cand, np.int64), 0, self._data.shape[0] - 1
            )
            g = jnp.asarray(
                self._data[idx.reshape(-1)], jnp.float32
            ).reshape(idx.shape + (self._data.shape[1],))
        else:
            g = jnp.take(
                self._data, jnp.asarray(cand, jnp.int32), axis=0
            )  # [Q,R,D]
        return _score(equery[:, None, :], g, self._dt, self._invert)


@partial(jax.jit, static_argnames=("k",))
def _mask_select(cand, fine_scores, k):
    """Masked final selection in ONE dispatch (a serving loop pays per-
    dispatch host cost — see serving.py). Coarse stages can pad
    underfilled rows with id -1 (IVF dedupe, approx extraction);
    rescorers CLIP ids before gathering, which would hand a pad slot
    row 0's real score — mask them out so a -1 can never outrank a true
    candidate."""
    fine_scores = jnp.where(cand >= 0, fine_scores, -jnp.inf)
    s, pos = jax.lax.top_k(fine_scores, k)
    return s, jnp.take_along_axis(cand, pos, axis=1)


class TwoStageIndex:
    """Coarse quantized top-R + fine rescoring top-k."""

    def __init__(
        self,
        coarse: EncodedVectors,
        fine,
        oversampling: float = 4.0,
        coarse_method: str = "approx",
    ):
        """``coarse_method`` is the coarse stage's selection method: the
        coarse stage feeds an oversampled candidate set into exact
        rescoring, so its own selection may be approximate. Both methods
        select exactly on this card (ops/topk.py)."""
        if oversampling < 1.0:
            raise ArgumentsError("oversampling must be >= 1")
        self.coarse = coarse
        self.fine = fine
        self.oversampling = float(oversampling)
        self.coarse_method = coarse_method

    def encode_query(self, queries):
        return (
            self.coarse.encode_query(queries),
            self.fine.encode_query(queries),
        )

    def top_k_device(self, equery, k: int, method: str = None,
                     recall_target=None):
        """Both stages stay on device; no host sync between coarse and
        fine. ``method`` overrides the constructor's coarse_method;
        ``recall_target`` rides through to the coarse stage's approx
        merge (every coarse family accepts it)."""
        eq_coarse, eq_fine = equery
        r = int(np.ceil(k * self.oversampling))
        r = min(r, self.coarse.count if self.coarse.count else r)
        # Route through the coarse quantizer's own top_k_device, which
        # blocks the corpus past ops.topk.BLOCK_ROWS (bounded [Q, block]
        # score memory at the coarse stage, which scans the whole corpus).
        _, cand = self.coarse.top_k_device(
            eq_coarse, r, method=method or self.coarse_method,
            recall_target=recall_target,
        )
        cand = jnp.asarray(cand)  # [Q, R]
        fine_scores = jnp.asarray(
            self.fine.score_candidates(eq_fine, cand)
        )  # [Q, R]
        return _mask_select(cand, fine_scores, min(k, r))

    def top_k(
        self, equery, k: int, method: str = None, recall_target=None
    ) -> Tuple[np.ndarray, np.ndarray]:
        s, idx = self.top_k_device(
            equery, k, method=method, recall_target=recall_target
        )
        return np.asarray(s), np.asarray(idx)
