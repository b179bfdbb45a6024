"""OPQ — Optimized Product Quantization: a learned orthogonal rotation
applied before PQ chunking (Ge et al., "Optimized Product Quantization",
CVPR 2013). The reference has plain PQ only (encoded_vectors_pq.rs); this
extension exists because on realistic embedding distributions — low
effective rank, correlated coordinates — plain PQ's independent per-chunk
codebooks waste bits modeling cross-chunk correlation, and a single
orthogonal rotation recovers most of that loss (recall measured on a
seeded realistic 10M corpus). Scoring is untouched: codes and LUTs live in
the rotated space, dot and L2 are rotation-invariant, so search cost is
identical to plain PQ; L1 is NOT preserved by rotation and is rejected at
the model layer.

Batched formulation:
  * parametric init (OPQ-P): eigen-decompose the second-moment matrix and
    greedily pack eigenvectors into chunks balancing the per-chunk
    log-variance product — the known-good init for non-parametric OPQ.
  * non-parametric refinement (OPQ-NP): alternate warm-started batched
    k-means (ops/kmeans.py — every chunk clustered in one device program)
    with the orthogonal Procrustes solve min_R ||X R - X_hat||_F =>
    R = U V^T where U S V^T = svd(X^T X_hat). Everything is a device
    matmul except the [D, D] SVD (host LAPACK, D is the vector dim).
"""

from __future__ import annotations

from typing import List, Tuple

import jax.numpy as jnp
import numpy as np

from ..core.types import check_stop
from . import pq as pq_ops
from .kmeans import kmeans_batched

OPQ_OUTER_ITERATIONS = 10
OPQ_INNER_ITERATIONS = 25


def pca_allocation_init(
    sample: np.ndarray, division: List[Tuple[int, int]]
) -> np.ndarray:
    """OPQ-P init: rotation whose output coordinates are the sample's
    principal directions, permuted so each chunk receives an
    (approximately) equal product of eigenvalues — the balanced-variance
    allocation of Ge et al. §4. Greedy: walk eigenvalues in descending
    order; each goes to the chunk with the smallest current log-product
    AMONG the least-filled chunks. The fill constraint is load-bearing:
    eigenvalues are < 1 on normalized data, so an unconstrained
    min-log-product greedy feeds every new eigenvalue to whichever bucket
    just got one (its product only shrank) and the top of the spectrum
    piles into the first chunk — the exact opposite of balance (measured:
    recall 0.16 vs 0.68 plain PQ at 100k x 768 before the constraint).
    Returns f32[dim, dim], orthogonal (columns are permuted eigenvectors
    of a symmetric matrix)."""
    x = np.asarray(sample, np.float64)
    dim = x.shape[1]
    cov = (x.T @ x) / max(1, x.shape[0])
    w, e = np.linalg.eigh(cov)  # ascending
    order = np.argsort(w)[::-1]
    w, e = w[order], e[:, order]
    caps = [en - st for st, en in division]
    m = len(division)
    logs = np.zeros(m)
    buckets: List[List[int]] = [[] for _ in range(m)]
    for j in range(dim):
        open_b = [b for b in range(m) if len(buckets[b]) < caps[b]]
        min_fill = min(len(buckets[b]) for b in open_b)
        level_b = [b for b in open_b if len(buckets[b]) == min_fill]
        b = min(level_b, key=lambda bb: logs[bb])
        buckets[b].append(j)
        logs[b] += np.log(max(w[j], 1e-12))
    perm = [j for b in range(m) for j in buckets[b]]
    return np.ascontiguousarray(e[:, perm], dtype=np.float32)


def _reconstruct_rows(codes, c_chunks, division, dim: int):
    """Decode codes back to rotated-space rows: u8[S, m] + f32[m, k, dmax]
    -> f32[S, dim] (inverse of chunk_rows_device's pad+reshape layout)."""
    idx = jnp.transpose(codes).astype(jnp.int32)[:, :, None]  # [m, S, 1]
    rec = jnp.take_along_axis(c_chunks, idx, axis=1)  # [m, S, dmax]
    s = rec.shape[1]
    flat = jnp.reshape(jnp.transpose(rec, (1, 0, 2)), (s, -1))
    return flat[:, :dim]


def train_opq(
    sample: np.ndarray,
    division: List[Tuple[int, int]],
    k: int,
    *,
    seed: int = 0,
    stop_condition=None,
    outer_iterations: int = OPQ_OUTER_ITERATIONS,
    inner_iterations: int = OPQ_INNER_ITERATIONS,
    final_iterations: int = pq_ops.KMEANS_MAX_ITERATIONS,
    accuracy: float = pq_ops.KMEANS_ACCURACY,
    init_rotation: np.ndarray = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Train (rotation, centroids) on a sample.

    Returns (R f32[dim, dim], centroids f32[k, dim]); centroids live in
    the ROTATED space (they quantize x @ R). The final k-means runs the
    reference's full iteration budget (encoded_vectors_pq.rs:23) so a
    rotation-less run of this function would match plain PQ training.
    """
    sample = np.asarray(sample, np.float32)
    dim = sample.shape[1]
    rot = (
        np.asarray(init_rotation, np.float32)
        if init_rotation is not None
        else pca_allocation_init(sample, division)
    )
    x = jnp.asarray(sample)
    rot_j = jnp.asarray(rot)
    cents = None
    for _ in range(outer_iterations):
        check_stop(stop_condition)
        xc = pq_ops.chunk_rows_device(x @ rot_j, division)
        cents = kmeans_batched(
            xc, k, max_iterations=inner_iterations, accuracy=accuracy,
            seed=seed, stop_condition=stop_condition, init=cents,
        )
        codes = pq_ops.encode_batch(xc, cents)  # u8[S, m]
        xhat = _reconstruct_rows(codes, cents, division, dim)
        # Procrustes step: R = U V^T of X^T X_hat (f64 on host — the SVD
        # conditions the whole fit and is tiny at [D, D]).
        m64 = np.asarray(jnp.matmul(x.T, xhat), dtype=np.float64)
        u, _, vt = np.linalg.svd(m64)
        rot = np.ascontiguousarray(u @ vt, dtype=np.float32)
        rot_j = jnp.asarray(rot)
    check_stop(stop_condition)
    xc = pq_ops.chunk_rows_device(x @ rot_j, division)
    cents = kmeans_batched(
        xc, k, max_iterations=final_iterations, accuracy=accuracy,
        seed=seed, stop_condition=stop_condition, init=cents,
    )
    return rot, pq_ops.chunks_to_centroids(np.asarray(cents), division, dim)
