"""IVF — inverted-file coarse index: cluster the corpus, store codes
bucket-major, and scan only the buckets nearest each query.

No reference counterpart: qdrant/quantization is a full-scan scoring crate
(its consumer runs graph search outside the crate, see SURVEY.md §0). This
extension exists because a full scan costs the whole corpus's bytes and
operations no matter how few neighbors a query actually needs, and an
inverted file turns that into work proportional to the probed fraction.

Batch-first formulation (vs the CPU IVF idiom of per-list pointer chasing):
  * FIXED-SIZE buckets: each k-means cluster's run is split into chunks of
    exactly ``bucket_size`` rows, so every probe is a static-shape [S]
    slice — no ragged lists, no dynamic shapes under jit.
  * S-ALIGNED permutation: the corpus is permuted cluster-major once at
    build and padded so bucket b owns inner rows [b*S, (b+1)*S) exactly.
    Pad slots DUPLICATE a real row of the same bucket (id mask -1 hides
    them at search): calibration/training see only genuine data vectors,
    and candidate gathers are whole contiguous blocks, not row soup.
  * probing is one [Q, B] matmul against per-bucket means + ``top_k`` —
    buckets, not clusters, are the probe unit, so a dense cluster
    contributes several independently-rankable probe targets.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import check_stop
from .kmeans import kmeans_batched

IVF_SAMPLE_PER_CENTER = 64  # training rows per center (cap below)
# Sample caps. The small cap bounds the IN-CORE trainer (kmeans_batched
# materializes an [n, nlist] distance tensor); past it the streamed
# blocked-Lloyd trainer takes over, whose own cap only bounds build-host
# sample memory (4.19M x 768 f32 = 12.3 GB — within the documented
# ~24 B/row build-host envelope at the scales that need it). Round-4
# review finding: the old single 262k cap silently degraded large-nlist
# geometries to <= 8 rows/center (degenerate k-means at nlist ~ 32k).
IVF_SAMPLE_CAP = 262_144
IVF_SAMPLE_CAP_BIG = 4_194_304
ASSIGN_BLOCK = 65_536  # rows per device assignment call
# Cap on any [rows, centers] f32 score transient (assignment + training).
_SCORES_BYTES_CAP = 1 << 31
# Residual indexes keep bucket_size a multiple of this (the removed
# kernels' correction-block width; the XLA scan does not need it, and
# lifting it is ROADMAP Design 4).
RESIDUAL_ALIGN = 512


def sample_cap(nlist: int) -> int:
    """Training-sample row cap for ``nlist`` centers: the in-core cap
    while it guarantees >= IVF_SAMPLE_PER_CENTER rows/center, else the
    streamed trainer's (much higher) cap."""
    if IVF_SAMPLE_PER_CENTER * nlist <= IVF_SAMPLE_CAP:
        return IVF_SAMPLE_CAP
    return IVF_SAMPLE_CAP_BIG


def train_centers(
    sample,
    nlist: int,
    *,
    seed: int = 0,
    stop_condition=None,
    max_iterations: int = 25,
) -> np.ndarray:
    """k-means centers f32[nlist, D] on a sample.

    Small problems (the [n, nlist] distance tensor fits
    ``_SCORES_BYTES_CAP``) run the one-call batched trainer (the same
    Lloyd's machinery PQ training uses, m=1). Big ones — the
    capacity-scale coarse geometries, e.g. nlist ~ 32k x 2M sample rows
    — run the STREAMED blocked-Lloyd trainer: sample resident on device,
    one jitted scan over row blocks per iteration, running-min over
    center blocks, segment-sum updates. ``sample`` may be a device array
    (stays put — the capacity benches generate it on device) or host
    numpy (uploaded once)."""
    n = int(sample.shape[0])
    nlist = min(nlist, n)
    if n * nlist * 4 <= _SCORES_BYTES_CAP:
        cents = kmeans_batched(
            jnp.asarray(sample, jnp.float32)[None], nlist,
            max_iterations=max_iterations,
            seed=seed, stop_condition=stop_condition,
        )
        return np.asarray(cents[0])
    return _train_centers_streamed(
        sample, nlist, seed=seed, stop_condition=stop_condition,
        max_iterations=max_iterations,
    )


def _center_blocks(nlist: int) -> tuple:
    """(ncb, cb): split ``nlist`` centers into ncb blocks of cb
    (128-lane aligned, near-even so padding stays small) whose
    [ASSIGN_BLOCK, cb] score transient respects the cap."""
    max_cb = max(128, _SCORES_BYTES_CAP // (4 * ASSIGN_BLOCK))
    ncb = -(-nlist // max_cb)
    cb = -(-nlist // ncb)
    cb += (-cb) % 128
    return ncb, cb


def _assign_blocked(x, centers, cc):
    """argmin_c ||x - c||^2 for one row block, scanning center blocks
    [ncb, cb, D] with a running (best, argbest) — no [rows, nlist]
    materialization. Pad centers carry +inf norms so they never win."""
    ncb, cb = centers.shape[0], centers.shape[1]

    def step(carry, cb_idx):
        best, arg = carry
        c = jax.lax.dynamic_index_in_dim(centers, cb_idx, keepdims=False)
        c2 = jax.lax.dynamic_index_in_dim(cc, cb_idx, keepdims=False)
        s = c2[None, :] - 2.0 * (x @ c.T)  # [rows, cb]
        m = jnp.min(s, axis=1)
        a = jnp.argmin(s, axis=1).astype(jnp.int32) + cb_idx * cb
        take = m < best
        return (jnp.where(take, m, best), jnp.where(take, a, arg)), None

    init = (
        jnp.full((x.shape[0],), jnp.inf, jnp.float32),
        jnp.zeros((x.shape[0],), jnp.int32),
    )
    (_, arg), _ = jax.lax.scan(
        step, init, jnp.arange(ncb, dtype=jnp.int32)
    )
    return arg


def _pad_centers(centers, nlist):
    """(centers [ncb, cb, D], cc [ncb, cb]) blocked + padded; pad rows get
    +inf squared-norm so argmin never selects them."""
    ncb, cb = _center_blocks(nlist)
    cpad = ncb * cb
    c = jnp.asarray(centers, jnp.float32)
    c = jnp.pad(c, ((0, cpad - nlist), (0, 0)))
    cc = jnp.sum(c * c, axis=1)
    cc = cc.at[nlist:].set(jnp.inf)
    d = c.shape[1]
    return c.reshape(ncb, cb, d), cc.reshape(ncb, cb)


def assign_clusters(
    data, centers, *, stop_condition=None
) -> np.ndarray:
    """Nearest-center (L2) assignment i32[N], blocked on device over BOTH
    axes (rows, and centers when [block, nlist] scores would exceed the
    transient cap — the nlist ~ 32k capacity geometries). L2 argmin is
    the right probe geometry for DOT corpora too once means are scored
    with the index metric at query time (the classic IVF recipe)."""
    nlist = int(centers.shape[0])
    cblk, ccblk = _pad_centers(centers, nlist)
    out = np.empty((data.shape[0],), np.int32)
    for b0 in range(0, data.shape[0], ASSIGN_BLOCK):
        check_stop(stop_condition)
        xb = jnp.asarray(data[b0 : b0 + ASSIGN_BLOCK], jnp.float32)
        out[b0 : b0 + xb.shape[0]] = np.asarray(
            _assign_jit(xb, cblk, ccblk)
        )
    return out


_assign_jit = jax.jit(_assign_blocked)


@partial(jax.jit, donate_argnums=(1,), static_argnames=("rb", "nlist"))
def _lloyd_streamed_iter(sample, centers, reseed, *, rb, nlist):
    """One full Lloyd iteration over a device-resident sample: scan row
    blocks, assign against center blocks (running min), accumulate
    per-center sums/counts by segment-sum. Empty centers reseed from the
    provided random sample rows. Returns (new_centers [nlist, D], diff)."""
    n, d = sample.shape
    nb = n // rb
    cblk, ccblk = _pad_centers(centers, nlist)

    def body(carry, bi):
        sums, counts = carry
        x = jax.lax.dynamic_slice_in_dim(sample, bi * rb, rb)
        idx = _assign_blocked(x, cblk, ccblk)
        sums = sums.at[idx].add(x)
        counts = counts.at[idx].add(1.0)
        return (sums, counts), None

    (sums, counts), _ = jax.lax.scan(
        body,
        (
            jnp.zeros((nlist, d), jnp.float32),
            jnp.zeros((nlist,), jnp.float32),
        ),
        jnp.arange(nb, dtype=jnp.int32),
    )
    mean = sums / jnp.maximum(counts, 1.0)[:, None]
    new_c = jnp.where(
        (counts == 0)[:, None], jnp.take(sample, reseed, axis=0), mean
    )
    diff = jnp.sum(jnp.abs(new_c - centers))
    return new_c, diff


def _train_centers_streamed(
    sample,
    nlist: int,
    *,
    seed: int = 0,
    stop_condition=None,
    max_iterations: int = 25,
    accuracy: float = 1e-3,
) -> np.ndarray:
    """Blocked-Lloyd k-means for capacity-scale (sample x nlist) — see
    ``train_centers``. Reference semantics preserved at scale: first-k
    init (kmeans.rs:25), random reseed of empty clusters
    (kmeans.rs:111-118), L1-diff convergence (kmeans.rs:125-135),
    cancellation between iterations (kmeans.rs:29-31)."""
    n, d = int(sample.shape[0]), int(sample.shape[1])
    rb = min(n, ASSIGN_BLOCK // 8)  # [rb, cb] transient ~256 MB
    npad = n - n % rb if n >= rb else n  # trailing partial block dropped
    sample_dev = jnp.asarray(sample, jnp.float32)[:npad]
    centers = sample_dev[:nlist]
    host_rng = np.random.default_rng(seed)
    for _ in range(max_iterations):
        check_stop(stop_condition)
        reseed = jnp.asarray(
            host_rng.integers(0, npad, size=(nlist,)), jnp.int32
        )
        centers, diff = _lloyd_streamed_iter(
            sample_dev, centers, reseed, rb=rb, nlist=nlist
        )
        if float(diff) < accuracy * nlist:
            break
    return np.asarray(centers)


def build_buckets(
    assignments: np.ndarray, bucket_size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Split each cluster's run into fixed-size S-aligned buckets.

    Returns ``(perm, bucket_ids)``:
      * ``perm`` i64[B*S] — bucket b's slot s holds original row
        ``perm[b*S + s]``; pad slots REPEAT real corpus rows drawn from a
        GLOBAL cyclic cursor over 0..N-1 in bucket order (so
        ``data[perm]`` is a valid corpus with only genuine vectors, and —
        while total pads <= N — no original id occupies more than TWO
        slots: its own plus at most one pad copy; a runt cluster can
        never blow up the search's dedupe margin),
      * ``bucket_ids`` i32[B, S] — ORIGINAL row ids per slot, -1 in pad
        slots (the search-time mask; exactly one slot per original id is
        non-negative). The pad mapping is derivable from ``bucket_ids``
        + N alone (walk pads in bucket order, assign cursor % N), so it
        needs no extra storage across save/load.
    """
    assignments = np.asarray(assignments)
    n = assignments.shape[0]
    s = int(bucket_size)
    order = np.argsort(assignments, kind="stable")
    sorted_assign = assignments[order]
    starts = np.flatnonzero(
        np.diff(sorted_assign, prepend=sorted_assign[0] - 1)
    ) if n else np.zeros((0,), np.int64)
    ends = np.append(starts[1:], n)
    perm_rows = []
    id_rows = []
    pad_cursor = 0  # global cyclic pad fill (see docstring)
    for st, en in zip(starts, ends):
        # EVEN split of the cluster's run over its buckets (never one
        # full bucket + a runt tail): spreads the padding so no single
        # bucket is mostly pads.
        c = en - st
        nb_c = max(1, -(-c // s))
        for bi in range(nb_c):
            b0 = st + (c * bi) // nb_c
            b1 = st + (c * (bi + 1)) // nb_c
            members = order[b0:b1]
            fill = s - members.shape[0]
            if fill:
                pad = (pad_cursor + np.arange(fill)) % n
                pad_cursor = int((pad_cursor + fill) % n)
                perm_rows.append(np.concatenate([members, pad]))
                ids = np.full((s,), -1, np.int32)
                ids[: members.shape[0]] = members
                id_rows.append(ids)
            else:
                perm_rows.append(members)
                id_rows.append(members.astype(np.int32))
    if not perm_rows:
        return np.zeros((0,), np.int64), np.zeros((0, s), np.int32)
    perm = np.concatenate(perm_rows).astype(np.int64)
    bucket_ids = np.stack(id_rows).astype(np.int32)
    return perm, bucket_ids


def bucket_means(
    data: np.ndarray,
    perm: np.ndarray,
    bucket_ids: np.ndarray,
    *,
    block_buckets: int = 1024,
) -> np.ndarray:
    """f32[B, D] mean of each bucket's REAL member rows (pad duplicates
    excluded via the id mask) — the probe targets. Blocked gather so a
    10M x 768 corpus never materializes a full permuted copy."""
    nb, s = bucket_ids.shape
    dim = data.shape[1]
    if nb == 0:
        return np.zeros((0, dim), np.float32)
    out = np.empty((nb, dim), np.float32)
    for b0 in range(0, nb, block_buckets):
        b1 = min(b0 + block_buckets, nb)
        rows = data[perm[b0 * s : b1 * s]].reshape(b1 - b0, s, dim)
        valid = (bucket_ids[b0:b1] >= 0).astype(np.float32)[:, :, None]
        out[b0:b1] = (
            (rows * valid).sum(axis=1) / valid.sum(axis=1)
        ).astype(np.float32)
    return out


def residualize_inplace(
    permuted: np.ndarray,
    means: np.ndarray,
    bucket_ids: np.ndarray,
    *,
    block_buckets: int = 1024,
) -> None:
    """Turn the S-aligned permuted corpus into RESIDUALS in place
    (row -= its bucket's mean). Pad slots (bucket_ids < 0) get residual
    0 — they are score-masked at search, and zeroing keeps the inner
    quantizer's calibration on genuine residuals only. Blocked so the
    only full-size array touched is ``permuted`` itself."""
    nb, s = bucket_ids.shape
    for b0 in range(0, nb, block_buckets):
        b1 = min(b0 + block_buckets, nb)
        permuted[b0 * s : b1 * s] -= np.repeat(means[b0:b1], s, axis=0)
    pad = bucket_ids.reshape(-1) < 0
    if pad.any():
        permuted[pad] = 0.0


def sq_decoded_rowterm(
    codes: jax.Array,  # int8 [Npad, Dpad] (inner SQ codes over residuals)
    alpha: float,
    offset: float,
    means: jax.Array,  # f32 [B, dim]
    bucket_size: int,
    dim: int,
    *,
    block_buckets: int = 64,
) -> jax.Array:
    """f32[B*S] squared norms of the DECODED points |c_b + r^|^2 over the
    real dims (r^ = alpha*code + offset). The residual L2 score must pair
    the quantized cross term with the norm of the SAME decoded point —
    S = 2 q.v^ - |q|^2 - |v^|^2 = -|q - v^|^2 is a true metric on the
    decoded corpus, so per-row code errors cancel in ranking exactly as
    they do in the non-residual quantizer's self-consistent score. Using
    the EXACT |v|^2 instead adds an uncancelled norm-mismatch term that
    measurably destroys nearest-first ranking. Blocked on device."""
    nb = means.shape[0]
    s = bucket_size

    @partial(jax.jit, static_argnames=("bb",))
    def blk(cb, mb, bb):
        v = cb[:, :dim].astype(jnp.float32) * alpha + offset
        vhat = v + jnp.repeat(mb, s, axis=0)
        return jnp.sum(vhat * vhat, axis=1)

    parts = []
    for b0 in range(0, nb, block_buckets):
        b1 = min(b0 + block_buckets, nb)
        parts.append(
            blk(codes[b0 * s : b1 * s], means[b0:b1], b1 - b0)
        )
    return jnp.concatenate(parts) if parts else jnp.zeros((0,), jnp.float32)


def pq_decoded_rowterm(
    codes: Optional[jax.Array],  # uint8 [Npad, Mpad] (codes of residuals)
    c_chunks: jax.Array,  # f32 [m, k, dmax] chunked codebook
    rot: Optional[jax.Array],  # OPQ rotation (decode space = x @ rot)
    means: jax.Array,  # f32 [B, dim]
    bucket_size: int,
    division,
    *,
    block_buckets: int = 64,
    codes_t: Optional[jax.Array] = None,  # [Mpad, Npad] alternative
) -> jax.Array:
    """PQ twin of ``sq_decoded_rowterm``: |c_b + r^|^2 with
    r^ = concat of the rows' chunk centroids (rotated back for OPQ —
    norms are rotation-invariant, the cross term uses rotated means).
    Per bucket block: T2[b, chunk, code] = 2 (R c_b)_chunk . cent +
    |cent|^2, gathered by the rows' codes and summed over chunks."""
    from .pq import chunk_rows_device

    nb = means.shape[0]
    s = bucket_size
    m = len(division)
    # HIGHEST: these terms are data-scale and feed the per-row residual
    # additive; a reduced-precision f32 dot would inject rowadd noise
    # rivaling residual-scale score deltas.
    hp = jax.lax.Precision.HIGHEST
    mr = means if rot is None else jnp.matmul(means, rot, precision=hp)
    mean_norm = jnp.sum(means * means, axis=1)  # [B]
    cent_norm = jnp.sum(c_chunks * c_chunks, axis=2)  # [m, k]

    @partial(jax.jit, static_argnames=("bb",))
    def blk(codes_b, mrb, mnb, bb):
        mc = chunk_rows_device(mrb, division)  # [m, bb, dmax]
        t2 = 2.0 * jnp.einsum(
            "mbd,mkd->bmk", mc, c_chunks,
            preferred_element_type=jnp.float32, precision=hp,
        ) + cent_norm[None]  # [bb, m, k]
        ct = jnp.transpose(
            codes_b[:, :m].reshape(bb, s, m).astype(jnp.int32), (0, 2, 1)
        )  # [bb, m, s]
        g = jnp.take_along_axis(t2, ct, axis=2)  # [bb, m, s]
        return (jnp.sum(g, axis=1) + mnb[:, None]).reshape(bb * s)

    def code_block(b0, b1):
        # Transposed-first (capacity) storage: slice columns and
        # transpose just the block — never the full matrix.
        if codes is not None:
            return codes[b0 * s : b1 * s]
        return jnp.transpose(codes_t[:, b0 * s : b1 * s])

    parts = []
    for b0 in range(0, nb, block_buckets):
        b1 = min(b0 + block_buckets, nb)
        parts.append(
            blk(code_block(b0, b1), mr[b0:b1], mean_norm[b0:b1], b1 - b0)
        )
    return jnp.concatenate(parts) if parts else jnp.zeros((0,), jnp.float32)
