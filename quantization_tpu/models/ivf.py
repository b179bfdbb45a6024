"""IVFIndex — inverted-file search over any quantizer family.

An extension beyond the reference (qdrant/quantization is a full-scan
scoring crate): the corpus is clustered and permuted bucket-major at build
(ops/ivf.py), and a search scans only a probed subset of buckets — work
proportional to the probed fraction instead of the corpus. The inner
quantizer is any of the engine's families (SQ / PQ (+OPQ rotation) / BQ),
built over the S-aligned permuted corpus so bucket b owns inner rows
[b*S, (b+1)*S).

The scan is BATCH-UNION compaction, not per-query gathering: each query
votes for its ``nprobe`` nearest buckets, the ``nscan`` most-voted
buckets are gathered — whole contiguous [S, row] blocks — into one
compact sub-corpus, and the family's own score + select scans it for the
entire batch (see ``_ivf_search`` for the rationale). The entire search —
probe matmul, vote, compaction, scan, dedupe, select — is ONE jitted
dispatch (arrays passed as arguments, never baked as jit constants).

Plugs into ``TwoStageIndex`` as a coarse stage (it exposes the same
``encode_query`` / ``top_k_device`` / ``count`` surface), which gives the
full serving ladder: IVF probe -> quantized bucket scan -> f32 rescore.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.distances import pairwise_score
from ..core.types import (
    ArgumentsError,
    DistanceType,
    StorageIOError,
    VectorParameters,
    check_stop,
)
from ..ops import bq as bq_ops
from ..ops import ivf as ivf_ops
from ..ops import pq as pq_ops
from ..ops import sq as sq_ops
from ..ops import topk as topk_ops

NEG = np.float32(-3.0e38)  # plain scalar: no device init at import time


@dataclass
class _ResidualQueryU8:
    """Signed zero-centered query codes for residual-SQ scoring (see
    IVFIndex.encode_query): int8 [Q, Dpad] in [-127, 127] + f32 [Q]
    offset + the PER-QUERY effective multiplier A*aq*ar (a traced [Q]
    vector — each query carries its own code scale aq)."""

    codes: jax.Array
    offsets: jax.Array
    mult: jax.Array


@dataclass
class _ResidualQueryBQ:
    """ASYMMETRIC residual-BQ query (see IVFIndex.encode_query): the
    corpus keeps 1-bit residual signs, but the query side keeps its
    quantized VALUES — int8 [Q, Dpad] in [-127, 127] — so the affine
    scan scores q . sign(r) directly (a strictly better estimator of
    q . r than sign(q) . sign(r), at the same matmul cost). ``mult`` =
    2*A*beta*aq (traced [Q, 1] — aq is each query's own code scale) and
    ``qb`` = -A*beta*aq*sum(q^) complete mult*(qs.bits)+qb = A*beta*(q.sign r);
    beta = E|r_i| (metadata.residual_scale) maps sign units back to data
    units so the f32 bucket term A*(q . c_b) adds coherently."""

    codes: jax.Array
    mult: jax.Array
    qb: jax.Array


def _registry():
    from .bq import BinaryQuantizer
    from .pq import ProductQuantizer
    from .sq import ScalarQuantizerU8

    return {
        "sq": ScalarQuantizerU8,
        "pq": ProductQuantizer,
        "bq": BinaryQuantizer,
    }


@dataclass
class IVFMetadata:
    nlist: int
    bucket_size: int
    nprobe: int
    kind: str
    nbuckets: int
    vector_parameters: VectorParameters  # the ORIGINAL corpus (count = N)
    nscan: Optional[int] = None  # default batch-union width (None: 4*nprobe)
    residual: bool = False  # inner codes encode v - bucket_center
    residual_scale: float = 0.0  # beta = E|r_i| (residual-BQ only)

    def to_json(self) -> dict:
        out = {
            "nlist": self.nlist,
            "bucket_size": self.bucket_size,
            "nprobe": self.nprobe,
            "kind": self.kind,
            "nbuckets": self.nbuckets,
            "vector_parameters": self.vector_parameters.to_json(),
        }
        if self.nscan is not None:
            out["nscan"] = self.nscan
        if self.residual:
            out["residual"] = True
        if self.residual_scale:
            out["residual_scale"] = float(self.residual_scale)
        return out

    @classmethod
    def from_json(cls, obj: dict) -> "IVFMetadata":
        return cls(
            nlist=int(obj["nlist"]),
            bucket_size=int(obj["bucket_size"]),
            nprobe=int(obj["nprobe"]),
            kind=str(obj["kind"]),
            nbuckets=int(obj["nbuckets"]),
            vector_parameters=VectorParameters.from_json(
                obj["vector_parameters"]
            ),
            nscan=(
                int(obj["nscan"]) if obj.get("nscan") is not None else None
            ),
            residual=bool(obj.get("residual", False)),
            residual_scale=float(obj.get("residual_scale", 0.0)),
        )


def _derive_slot_ids(bucket_ids: np.ndarray, n: int):
    """``(slot_ids [B, S], max_dup)`` from the id mask: pad slots hold the
    id of the row they duplicate. ``build_buckets`` fills pads from a GLOBAL
    cyclic cursor over 0..N-1 in bucket order, so the mapping is derivable
    and needs no extra storage. ``max_dup`` is the worst-case slots per
    original id (1 + pad copies — the cursor wraps at most ceil(pads/N)
    times): the dedupe margin must fetch k * max_dup slots to guarantee k
    distinct ids."""
    slot_ids = np.asarray(bucket_ids, np.int32).reshape(
        np.asarray(bucket_ids).shape
    ).copy()
    nn = max(int(n), 1)
    pad_mask = slot_ids < 0
    total_pads = int(pad_mask.sum())
    if total_pads:
        slot_ids[pad_mask] = (
            np.arange(total_pads, dtype=np.int64) % nn
        ).astype(np.int32)
    max_dup = 1 + (-(-total_pads // nn) if total_pads else 0)
    return slot_ids, max_dup


def _residual_coeffs(dt: DistanceType, invert: bool):
    """Dot-expansion coefficients ``(a, rowcoef)`` for residual search (see
    IVFIndex._init_residual): ``a`` scales the inner score and the q.c_b
    bucket term, ``rowcoef`` the |v^|^2 per-row term (0 for DOT)."""
    s_sign = -1.0 if invert else 1.0
    if dt == DistanceType.DOT:
        return s_sign, 0.0
    return -2.0 * s_sign, s_sign  # L2 (L1 is rejected at encode)


def _residual_query_sq(q, alpha, offset, dpad, a, rc) -> _ResidualQueryU8:
    """Residual-SQ query codes (see IVFIndex.encode_query): zero-centered
    SIGNED codes, each query scaled by its OWN aq = max|q_i| / 127 (no
    batch coupling — the scan takes a per-query multiplier column),
    |q|^2 folded into the offset, the effective multiplier A*aq*ar a
    traced [Q] vector."""
    qn = jnp.sum(q * q, axis=1)
    aq = jnp.maximum(
        jnp.max(jnp.abs(q), axis=1, keepdims=True) / 127.0, 1e-30
    )
    qc = jnp.clip(jnp.round(q / aq), -127, 127).astype(jnp.int8)
    qc = jnp.pad(qc, ((0, 0), (0, dpad - qc.shape[1])))
    qoff = a * offset * jnp.sum(q, axis=1) + rc * qn
    return _ResidualQueryU8(qc, qoff, jnp.float32(a * alpha) * aq[:, 0])


def _residual_query_bq(q, dp, a, beta) -> _ResidualQueryBQ:
    """Residual-BQ asymmetric query (see _ResidualQueryBQ): quantized
    VALUE codes, each query scaled by its OWN aq = max|q_i| / 127 (no
    batch coupling — the scan takes a per-query multiplier column),
    affine completed so mult*(qs . bits) + qb = A*beta*(q . sign(r)):
    q . sign(r) = aq * (2*(q^ . bits) - sum(q^)) on the true dims (padded
    dims hit q^ = 0)."""
    aq = jnp.maximum(
        jnp.max(jnp.abs(q), axis=1, keepdims=True) / 127.0, 1e-30
    )
    qc = jnp.clip(jnp.round(q / aq), -127, 127).astype(jnp.int8)
    qc = jnp.pad(qc, ((0, 0), (0, dp - qc.shape[1])))
    sq_ = jnp.sum(qc.astype(jnp.float32), axis=1, keepdims=True)
    ab = jnp.float32(a * beta) * aq  # [Q, 1]
    return _ResidualQueryBQ(qc, 2.0 * ab, -ab * sq_)


def _residual_query_pq(lut, a):
    """Residual-PQ query LUT: ``a`` rescales the inner DOT entries. The
    per-query rc*|q|^2 term is NOT folded into the LUT: a data-scale
    constant (~|q|^2) sitting on residual-scale entries would cost them
    precision. It joins the f32 ``corr`` additive inside the search
    instead."""
    from .pq import EncodedQueryPQ

    return EncodedQueryPQ(a * lut)


def auto_geometry(count: int, residual: bool = False):
    """``(nlist, bucket_size)`` from the geometry rules: bucket_size 1024
    (2048 over-pads at sane nlist), halved for small corpora so the index
    keeps >= ~8 buckets of probing headroom; then nlist * bucket_size ~
    count / 3 (several buckets per k-means cell, bounded pad waste).
    ``residual`` floors bucket_size at ``ops.ivf.RESIDUAL_ALIGN`` (512).
    The sizes come from kernels this repo no longer has; retuning them
    for the current scan is ROADMAP Design 4."""
    s = 1024
    while s > 32 and count < 3 * 8 * s:
        s //= 2
    if residual:
        s = max(s, ivf_ops.RESIDUAL_ALIGN)
    return max(1, count // (3 * s)), s


def _bucket_priority(q, means, dt, invert, p):
    """Rank-fair batch-union priority per bucket [B]: a bucket's key rank
    is the best (lowest) probe rank ANY query gave it, so every query's
    rank-0 bucket enters the union before anyone's rank-1 bucket, and
    so on — at Q diverse queries and u >= Q each query is guaranteed
    its own nearest bucket, then its next ranks as width allows (pure
    vote-count starves unpopular queries completely at large Q). Votes
    break ties within a rank class; the batch-max probe score (mapped
    into (0, 0.5)) breaks vote ties and fills unvoted spare slots."""
    probe_scores = pairwise_score(q, means, dt, invert)  # [Q, B]
    _, probes = jax.lax.top_k(probe_scores, p)  # [Q, P]
    nq = q.shape[0]
    nb = means.shape[0]
    flat = probes.reshape(-1)
    ranks = jnp.broadcast_to(
        jnp.arange(p, dtype=jnp.float32)[None, :], probes.shape
    ).reshape(-1)
    minrank = jnp.full((nb,), float(p)).at[flat].min(ranks)
    votes = jnp.zeros((nb,), jnp.float32).at[flat].add(1.0)
    bmax = jnp.max(probe_scores, axis=0)
    tie = 0.5 * jax.nn.sigmoid(
        (bmax - jnp.mean(bmax)) / (jnp.std(bmax) + 1e-6)
    )
    return (float(p) - minrank) * float(nq * p + 1) + votes + tie


def _scan_buckets_compact(
    kind, eq, inner, union, *, nb, s, dt, invert, dim, kk2,
    corr=None, rowadd=None, pq_transposed=False,
):
    """Gather the union's buckets — whole contiguous [S, bytes] blocks —
    into one compact sub-corpus, score it with the family's score op and
    select. ``inner`` arrays must hold exactly ``nb`` buckets' rows along
    the corpus axis (callers slice). Returns (sv [Q, kk2], loc [Q, kk2])
    with ``loc`` a position in union-slot space [0, U*s).

    ``corr`` (residual indexes): per-(query, union bucket) additive
    [Q, U]; ``rowadd`` a per-slot additive [nb*s] (PQ only — SQ's rides
    voff). ``pq_transposed``: PQ codes arrive chunk-major [Mpad, Npad]
    (a transposed-first quantizer); only the union's columns are
    gathered and transposed."""
    u = union.shape[0]
    width = u * s

    if kind == "sq":
        qcodes, qoff = eq
        codes, voff, mult = inner
        d = codes.shape[1]
        g = jnp.take(
            codes[: nb * s].reshape(nb, s * d), union, axis=0
        ).reshape(width, d)
        gv = jnp.take(
            voff[: nb * s].reshape(nb, s), union, axis=0
        ).reshape(width)
        scores = sq_ops.score_batch_xla(
            qcodes, qoff, g, gv, mult, distance_type=dt
        )
    elif kind == "bq":
        (planes,) = inner
        w8 = planes.shape[0]
        g = jnp.take(
            planes[:, : nb * s].reshape(w8, nb, s), union, axis=1
        ).reshape(w8, width)
        if len(eq) == 3:  # residual: asymmetric affine query
            scores = bq_ops.score_affine_xla(*eq, g)
        else:
            scores = bq_ops.score_batch_xla(
                eq[0], g, distance_type=dt, invert=invert, dim=dim
            )
    else:  # pq
        (lut,) = eq
        (codes,) = inner
        m = lut.shape[1]
        # ROW gather (bucket blocks expanded to row ids): gathering via a
        # [nb, s*m] reshape would copy the whole matrix at capacity scale;
        # a flat row gather touches only the union's bytes.
        rows = (
            union[:, None] * s
            + jnp.arange(s, dtype=union.dtype)[None, :]
        ).reshape(-1)
        if pq_transposed:
            g = jnp.transpose(jnp.take(codes[:m], rows, axis=1))
        else:
            g = jnp.take(codes, rows, axis=0)[:, :m]  # [width, m]
        scores = pq_ops.score_lut_xla(lut, g)
        if rowadd is not None:
            ra_g = jnp.take(
                rowadd[: nb * s].reshape(nb, s), union, axis=0
            ).reshape(width)
            scores = scores + ra_g[None, :]
    if corr is not None:
        scores = scores + jnp.repeat(corr, s, axis=1)

    # Exact selection for every method (ops/topk.py).
    return jax.lax.top_k(scores, kk2)


def _union_bucket_term(q, means_u, corr_scale, kind, dt, invert):
    """Residual bucket term corr_scale * (q . c_b) [Q, U] for the scanned
    buckets' means only (UNION-FIRST: O(U), not an all-buckets [Q, B]
    matmul). HIGHEST: the term is data-scale (|q||c_b| ~ hundreds) while
    residual ranking is residual-scale; a reduced-precision f32 dot
    injects ~0.1-1 score noise here."""
    corr = jnp.matmul(
        means_u, q.T, precision=jax.lax.Precision.HIGHEST
    ) * corr_scale  # [U, Q]
    if kind == "pq":
        # PQ carries rc*|q|^2 here (f32, exact) rather than on the LUT —
        # see _residual_query_pq. SQ folds it into qoff.
        _, rc = _residual_coeffs(dt, invert)
        if rc != 0.0:
            corr = corr + rc * jnp.sum(q * q, axis=1)[None, :]
    return jnp.transpose(corr)


@partial(
    jax.jit,
    static_argnames=(
        "kind", "k", "p", "u", "dt", "invert", "s", "dim", "kk2",
        "pq_transposed",
    ),
)
def _ivf_search(
    q, eq, means, slot_ids, inner, resid=None,
    *, kind, k, p, u, dt, invert, s, dim, kk2=None, pq_transposed=False,
):
    """One-dispatch IVF search, batch-union compaction strategy.

    Per-query probing gathers scattered rows and scores each query alone,
    which turns the batch's shared matmul into Q small ones. Instead:
    every query votes for its ``p`` nearest buckets, the ``u`` top-priority
    buckets are gathered into one compact sub-corpus
    (``_scan_buckets_compact``) and scored for the whole batch. Every
    query is scored against the whole union (a superset of its own voted
    buckets that survived), so recall dominates same-width per-query
    probing. Pad slots duplicate real rows (valid codes, correct ids via
    ``slot_ids``); the final 2k-wide select is deduped by id.

    ``eq`` / ``inner`` are per-family array tuples (see
    ``IVFIndex._family_arrays``); everything else is static.

    ``resid`` (residual indexes, metadata.residual): ``(corr_scale,)``
    for SQ or ``(corr_scale, rowadd)`` for PQ — the inner codes score
    q . (v - c_b), and the bucket term corr_scale * (q . c_b) is computed
    here UNION-FIRST (one [U, D] x [D, Q] matmul against the scanned
    buckets' means only) and added before selection."""
    nq = q.shape[0]
    nb = means.shape[0]
    prio = _bucket_priority(q, means, dt, invert, p)
    _, union = jax.lax.top_k(prio, u)  # [U]
    if kk2 is None:  # dedupe margin: pad slots duplicate rows
        kk2 = min(2 * k, u * s)

    corr = rowadd = None
    if resid is not None:
        corr = _union_bucket_term(
            q, jnp.take(means, union, axis=0), resid[0], kind, dt, invert
        )
        if len(resid) > 1:
            rowadd = resid[1]

    sv, loc = _scan_buckets_compact(
        kind, eq, inner, union, nb=nb, s=s, dt=dt, invert=invert,
        dim=dim, kk2=kk2, corr=corr, rowadd=rowadd,
        pq_transposed=pq_transposed,
    )
    gids = jnp.take(slot_ids, union, axis=0).reshape(-1)  # [U*S]
    out_ids = jnp.take(gids, jnp.maximum(loc, 0))
    out_ids = jnp.where(loc >= 0, out_ids, -1)
    return _dedupe_select(sv, out_ids, nq, k, kk2)


def _check_method(method: str) -> None:
    if method not in topk_ops.METHODS:
        raise ArgumentsError(f"unknown top-k method {method!r}")


def _check_scan(scan: str) -> None:
    if scan == "indexed":
        raise ArgumentsError(
            "scan='indexed' (an in-place scan of the selected buckets) has "
            "no GPU implementation yet; use scan='auto' or 'compact' (see "
            "ROADMAP 'Removed, worth writing again for Hopper')"
        )
    if scan not in ("auto", "compact"):
        raise ArgumentsError(f"unknown scan strategy {scan!r}")


def _dedupe_select(sv, out_ids, nq, k, kk2):
    """Dedupe by id, keeping each id's HIGHEST-scored copy: sort by score
    desc, stable-sort by id (preserving score order within an id), poison
    repeats, reselect. Duplicate slots tie exactly for plain quantizers,
    but the sharded search gathers candidates in SHARD order (not score
    order) and residual pad-bucket copies are estimates, not clones — so
    first-seen-wins silently returns the wrong copy without the pre-sort."""
    so = jnp.argsort(-sv, axis=1)
    sv = jnp.take_along_axis(sv, so, axis=1)
    out_ids = jnp.take_along_axis(out_ids, so, axis=1)
    order = jnp.argsort(out_ids, axis=1)
    sid = jnp.take_along_axis(out_ids, order, axis=1)
    ssv = jnp.take_along_axis(sv, order, axis=1)
    dup = jnp.concatenate(
        [jnp.zeros((nq, 1), bool), sid[:, 1:] == sid[:, :-1]], axis=1
    )
    ssv = jnp.where(dup | (sid < 0), NEG, ssv)
    kk = min(k, kk2)
    sv2, pos = jax.lax.top_k(ssv, kk)
    out = jnp.take_along_axis(sid, pos, axis=1)
    out = jnp.where(sv2 > NEG, out, -1)
    if kk < k:
        sv2 = jnp.pad(sv2, ((0, 0), (0, k - kk)), constant_values=NEG)
        out = jnp.pad(out, ((0, 0), (0, k - kk)), constant_values=-1)
    return sv2, out


class IVFIndex:
    """Bucket-probing search index over an inner quantizer (batch-union
    compacted scans — see module docstring).

    ``quantizer`` scores the S-aligned PERMUTED corpus (count = B*S, pad
    slots duplicate real rows); ``bucket_ids`` maps slot (b, s) — inner
    row b*S + s — back to its original row id, -1 marking pad slots;
    ``bucket_means`` are the probe targets."""

    def __init__(
        self,
        quantizer,
        bucket_ids: np.ndarray,
        bucket_means: np.ndarray,
        metadata: IVFMetadata,
    ):
        self.quantizer = quantizer
        self.metadata = metadata
        self.params = metadata.vector_parameters
        self.bucket_ids = np.asarray(bucket_ids, np.int32)
        self.bucket_means = np.asarray(bucket_means, np.float32)
        # slot_ids: the original id whose CODE each slot holds — equals
        # bucket_ids on real slots; pad slots hold the id of the row they
        # duplicate (derivable, _derive_slot_ids). max_dup bounds slots
        # per id for the search's dedupe margin.
        slot_ids, self._max_dup = _derive_slot_ids(
            self.bucket_ids, self.params.count
        )
        if metadata.residual and metadata.kind == "bq":
            # Residual-BQ: mask within-bucket pad slots outright. The
            # global-cursor pad fill duplicates rows ACROSS buckets, and
            # a residual code is only a valid estimator when scored with
            # ITS OWN bucket's q.c_b term — a cross-bucket copy scores
            # q.r^ + q.c_OTHER, garbage that can outrank (or shadow, in
            # gather order) the true copy. SQ/PQ poison pads through
            # their per-slot additives (NEG row terms); the 1-bit plane
            # layout has no such carrier, so the id map drops them
            # instead (the search already maps id -1 -> discarded).
            # Masking also keeps sharded-built files consistent: their
            # pad codes are COPIES of the primary (residual-vs-primary-
            # bucket), wrong for any other bucket by construction.
            slot_ids = np.where(self.bucket_ids >= 0, slot_ids, -1)
        self._slot_ids_dev = jnp.asarray(slot_ids)
        self._means_dev = jnp.asarray(self.bucket_means)
        if metadata.residual:
            self._init_residual()
        else:
            self._resid_sq = self._resid_pq = None

    def _init_residual(self):
        """Derive the residual search's effective arrays from the inner
        DOT scorer via dot-expansion (the inner quantizer approximates
        q . r^ with r = v - c_b, v^ = c_b + r^ the decoded point):

          DOT:  S = s * (q.v^)          = s*inner + s*(q.c_b)
          L2:   S = s * |q - v^|^2      = -2s*inner - 2s*(q.c_b)
                                          + s*|q|^2 + s*|v^|^2
          (s = -1 when ``invert`` else +1 — matching the non-residual
          quantizers' sign convention, ops/sq.py multiplier_for)

        so: A (the coefficient on the inner score and on q.c_b) rescales
        the inner multiplier / LUT and the corr term; |q|^2 folds into
        the query offset (SQ) or one LUT chunk (PQ); |v^|^2 — the
        DECODED norm, recomputed from the codes on device here (nothing
        extra to checkpoint; see ops/ivf.py sq_decoded_rowterm on why it
        must be the decoded norm, not the exact one) — folds into voff
        (SQ) or the per-row additive (PQ). Pad slots get NEG
        there, masking them (their residuals are vs a foreign bucket's
        mean and would score garbage)."""
        a, rowcoef = _residual_coeffs(
            self.params.distance_type, self.params.invert
        )
        self._res_a, self._res_rowcoef = a, rowcoef
        self._corr_scale_dev = jnp.float32(a)
        pad = self.bucket_ids.reshape(-1) < 0
        nslots = self.bucket_ids.size
        s = self.metadata.bucket_size
        qz = self.quantizer
        if self.metadata.kind == "bq":
            # DOT only (gated at encode): no |v^|^2 rowterm, and the BQ
            # layout has no per-slot additive carrier anyway — pad slots
            # duplicate same-layout real rows and dedupe handles them.
            # beta (metadata.residual_scale) rides the query affine.
            if not self.metadata.residual_scale > 0.0:
                raise ArgumentsError(
                    "residual BQ index needs metadata.residual_scale > 0 "
                    "(beta = E|r_i|, set by IVFIndex.encode)"
                )
            self._resid_sq = self._resid_pq = None
            return
        if self.metadata.kind == "sq":
            # The query side does NOT reuse the inner [0,127] affine (a
            # data-scale query would clip against the residual range):
            # encode_query builds zero-centered SIGNED codes q^ = aq * Q,
            # so q.r^ = aq*ar*(Q.C) + off_r*sum(q) — no per-row cross
            # term at all. voff carries only s*|v^|^2 and the pad mask;
            # the per-query multiplier A*aq*ar rides the scan's traced
            # multiplier column (_ResidualQueryU8.mult).
            meta = qz.metadata
            ve = np.zeros(np.asarray(qz.voffsets).shape[0], np.float32)
            if rowcoef != 0.0:
                rt = np.asarray(
                    ivf_ops.sq_decoded_rowterm(
                        qz.codes, meta.alpha, meta.offset,
                        self._means_dev, s, self.params.dim,
                    )
                )
                ve[:nslots] = rowcoef * rt
            ve[:nslots][pad] = NEG
            ve[nslots:] = NEG
            self._resid_sq = jnp.asarray(ve)
            self._resid_pq = None
        else:  # pq
            # Read whichever layout the quantizer actually holds — a
            # transposed-first (capacity) quantizer must not materialize
            # the row-major copy just to derive row terms.
            transposed = qz._codes is None
            nrows = (
                qz._codes_t.shape[1] if transposed else qz._codes.shape[0]
            )
            ra = np.zeros(nrows, np.float32)
            if rowcoef != 0.0:
                rt = np.asarray(
                    ivf_ops.pq_decoded_rowterm(
                        None if transposed else qz.codes,
                        qz._c_chunks, qz._rot,
                        self._means_dev, s,
                        qz.metadata.vector_division,
                        codes_t=qz._codes_t if transposed else None,
                    )
                )
                ra[:nslots] = rowcoef * rt
            ra[:nslots][pad] = NEG
            ra[nslots:] = NEG
            self._resid_pq = jnp.asarray(ra)
            self._resid_sq = None

    # ------------------------------------------------------------- build
    @classmethod
    def encode(
        cls,
        data,
        params: VectorParameters,
        *,
        quantizer: str = "sq",
        nlist: Optional[int] = None,
        bucket_size: Optional[int] = None,
        nprobe: int = 32,
        nscan: Optional[int] = None,
        seed: int = 0,
        residual: bool = False,
        stop_condition=None,
        **quantizer_kwargs,
    ) -> "IVFIndex":
        """Cluster + permute + inner-encode.

        ``nlist`` / ``bucket_size`` default to ``auto_geometry``
        (nlist * S ~ count/3); pass either explicitly to pin it (the
        other is still derived).

        ``data`` must be a materialized [count, dim] array (the build
        permutes it cluster-major; streaming callables are the full-scan
        classes' domain). ``quantizer`` is "sq" | "pq" | "bq" or one of
        the quantizer classes; extra kwargs (quantile, chunk_size, bits,
        rotation, ...) pass through to its ``encode``. The inner corpus is
        padded to nbuckets * bucket_size rows with duplicates of real
        rows (<= one bucket per cluster is partial), masked at search.

        ``residual=True`` (SQ/PQ DOT/L2; BQ DOT): the inner quantizer
        encodes r = v - bucket_center as a plain DOT scorer — residuals
        span a far smaller ball than the data, so the same code budget
        spends its resolution where the ranking signal lives (the IVF-PQ
        recipe; no reference counterpart). The bucket term q . c_b is
        restored at search (see _ivf_search). Needs bucket_size to be a
        multiple of ``ops.ivf.RESIDUAL_ALIGN`` (512).
        Residual BQ keeps 1-bit residual SIGNS on the corpus side but
        scores them against the query's quantized VALUES (asymmetric;
        _ResidualQueryBQ) with beta = E|r_i| bridging the units — DOT
        only (the L2 expansion needs a per-slot additive the plane
        layout can't carry). L1 is excluded (no dot-expansion).

        Residual-BQ regime: it lifts recall when the within-bucket score
        spread exceeds the 1-bit estimator's noise floor ~beta*|q|
        (clustered/unnormalized corpora: recall 0.02 -> 0.18 at
        200k x 768). On unit-normalized corpora with isotropic residuals
        the spread is ~|r|^2/sqrt(d), far below beta*|q|, and residual-BQ
        is a wash (recall 0.143 -> 0.127 at 500k x 768) — use residual
        SQ/PQ there."""
        registry = _registry()
        if isinstance(quantizer, str):
            if quantizer not in registry:
                raise ArgumentsError(
                    f"quantizer must be one of {sorted(registry)}, "
                    f"got {quantizer!r}"
                )
            kind = quantizer
            qcls = registry[kind]
        else:
            qcls = quantizer
            kind = next(
                (kk for kk, c in registry.items() if c is qcls), None
            )
            if kind is None:
                raise ArgumentsError(
                    f"unsupported quantizer class {qcls!r}"
                )
        if callable(data) and not hasattr(data, "shape"):
            raise ArgumentsError(
                "IVFIndex.encode needs a materialized array "
                "(the build permutes the corpus)"
            )
        data = np.asarray(data, np.float32)
        if data.shape != (params.count, params.dim):
            raise ArgumentsError(
                f"data shape {data.shape} does not match vector "
                f"parameters ({params.count}, {params.dim})"
            )
        if params.count < 1:
            raise ArgumentsError("IVFIndex needs a non-empty corpus")
        if bucket_size is None:
            bucket_size = auto_geometry(params.count, residual)[1]
        if nlist is None:
            nlist = max(1, params.count // (3 * bucket_size))
        if bucket_size < 1 or nlist < 1:
            raise ArgumentsError("nlist and bucket_size must be >= 1")
        if residual:
            if params.distance_type == DistanceType.L1:
                raise ArgumentsError(
                    "residual=True needs DOT or L2 (dot-expansion)"
                )
            if (
                kind == "bq"
                and params.distance_type != DistanceType.DOT
            ):
                raise ArgumentsError(
                    "residual=True with quantizer 'bq' supports DOT only "
                    "(the L2 expansion needs a per-slot |v^|^2 additive, "
                    "which the 1-bit plane layout has no carrier for)"
                )
            if bucket_size % ivf_ops.RESIDUAL_ALIGN:
                raise ArgumentsError(
                    f"residual=True needs bucket_size to be a multiple "
                    f"of {ivf_ops.RESIDUAL_ALIGN}, got {bucket_size}"
                )
            if kind == "bq":
                # Measured regime rule (recall on seeded corpora): on
                # unit-NORMALIZED
                # corpora the within-bucket score spread (~|r|^2/sqrt(d))
                # sits below the asymmetric 1-bit estimator's noise floor
                # (~beta*|q|), so residual-BQ LOSES recall vs plain signs
                # (10M x 768 normalized: coarse 0.330 -> 0.277, rescored
                # 0.935 -> 0.918 at equal scan cost). Warn before the
                # build spends the work.
                rng_norms = np.random.default_rng(seed ^ 0x5EED)
                nidx = rng_norms.choice(
                    params.count, size=min(params.count, 4096),
                    replace=False,
                )
                norms = np.linalg.norm(
                    np.asarray(data[nidx], np.float32), axis=1
                )
                if norms.size and float(np.mean(np.abs(norms - 1.0))) < 0.02:
                    import warnings

                    warnings.warn(
                        "residual=True with quantizer='bq' on a "
                        "unit-normalized corpus: measured on this regime "
                        "residual-BQ REDUCES recall vs plain IVF-BQ "
                        "(10M x 768 normalized: coarse 0.330 -> 0.277, "
                        "rescored 0.935 -> 0.918 at equal scan cost). Keep "
                        "residual=False for BQ here and spend the win on "
                        "rescore depth R, or use residual SQ/PQ.",
                        stacklevel=2,
                    )
        check_stop(stop_condition)

        n = params.count
        rng = np.random.default_rng(seed)
        sample_n = min(
            n,
            max(nlist, ivf_ops.IVF_SAMPLE_PER_CENTER * nlist),
            ivf_ops.sample_cap(nlist),
        )
        sample_idx = (
            rng.choice(n, size=sample_n, replace=False)
            if sample_n < n else np.arange(n)
        )
        centers = ivf_ops.train_centers(
            data[sample_idx], nlist, seed=seed,
            stop_condition=stop_condition,
        )
        assignments = ivf_ops.assign_clusters(
            data, centers, stop_condition=stop_condition
        )
        perm, bucket_ids = ivf_ops.build_buckets(assignments, bucket_size)
        means = ivf_ops.bucket_means(data, perm, bucket_ids)
        check_stop(stop_condition)
        permuted = data[perm]
        residual_scale = 0.0
        if residual:
            ivf_ops.residualize_inplace(permuted, means, bucket_ids)
            if kind == "bq":
                # beta = E|r_i| over a row sample: maps the asymmetric
                # estimator's sign units back to data units (see
                # _ResidualQueryBQ). Sampled, not full — at capacity
                # scale `permuted` is tens of GB of host memory.
                ridx = rng.choice(
                    perm.shape[0],
                    size=min(perm.shape[0], 262_144),
                    replace=False,
                )
                residual_scale = max(
                    float(np.mean(np.abs(permuted[ridx]))), 1e-30
                )
            inner_params = VectorParameters(
                params.dim, perm.shape[0], DistanceType.DOT, False
            )
        else:
            inner_params = VectorParameters(
                params.dim, perm.shape[0],
                params.distance_type, params.invert,
            )
        inner = qcls.encode(
            permuted, inner_params, stop_condition=stop_condition,
            **quantizer_kwargs,
        )
        meta = IVFMetadata(
            nlist=nlist, bucket_size=bucket_size, nprobe=nprobe,
            kind=kind, nbuckets=bucket_ids.shape[0],
            vector_parameters=params, nscan=nscan, residual=residual,
            residual_scale=residual_scale,
        )
        return cls(inner, bucket_ids, means, meta)

    # ------------------------------------------------------------- query
    @property
    def count(self) -> int:
        return self.params.count

    def encode_query(self, queries):
        q = jnp.asarray(queries, jnp.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != self.params.dim:
            raise ArgumentsError(
                f"query dim {q.shape[1]} != corpus dim {self.params.dim}"
            )
        if not self.metadata.residual:
            return q, self.quantizer.encode_query(np.asarray(q))
        # Residual index: fold the dot-expansion's query-side terms in
        # here (see _init_residual). A rescales, |q|^2 (L2 only) adds.
        # Each query's signed codes carry its OWN scale aq = max|q_i|/127
        # (the scan takes a per-query multiplier column), so a query's
        # quantization — and its returned scores — never depend on which
        # other queries share the batch.
        a, rc = self._res_a, self._res_rowcoef
        if self.metadata.kind == "bq":
            dp = self.quantizer.planes.shape[0] * 32
            return q, _residual_query_bq(
                q, dp, a, self.metadata.residual_scale
            )
        if self.metadata.kind == "sq":
            # Zero-centered signed query codes, each with its OWN scale
            # (the inner [0,127] affine spans the residual range —
            # a data-scale query would clip against it): q^ = aq * Q,
            # Q in [-127, 127], aq = max|q| / 127 per query. Then
            #   q . r^ = aq*ar*(Q . C) + off_r * sum(q)
            # (exact-f32 second term; padded dims hit Q = 0).
            meta = self.quantizer.metadata
            return q, _residual_query_sq(
                q, meta.alpha, meta.offset, self.quantizer.codes.shape[1],
                a, rc,
            )
        eq = self.quantizer.encode_query(np.asarray(q))
        return q, _residual_query_pq(eq.lut, a)

    def _family_arrays(self, eq_inner) -> Tuple[tuple, tuple]:
        kind = self.metadata.kind
        qz = self.quantizer
        if kind == "sq":
            if self.metadata.residual:
                return (
                    (eq_inner.codes, eq_inner.offsets),
                    (qz.codes, self._resid_sq, eq_inner.mult),
                )
            return (
                (eq_inner.codes, eq_inner.offsets),
                (qz.codes, qz.voffsets, qz._mult_dev),
            )
        if kind == "bq":
            if self.metadata.residual:
                return (
                    (eq_inner.codes, eq_inner.mult, eq_inner.qb),
                    (qz.planes,),
                )
            return (eq_inner.planes,), (qz.planes,)
        # PQ scans whichever layout the quantizer holds: a transposed-first
        # quantizer must not materialize its full row-major copy.
        if qz._codes is None:
            return (eq_inner.lut,), (qz._codes_t,)
        return (eq_inner.lut,), (qz.codes,)

    def top_k_device(
        self,
        equery,
        k: int,
        method: str = "exact",
        nprobe: Optional[int] = None,
        nscan: Optional[int] = None,
        scan: str = "auto",
        recall_target: Optional[float] = None,
    ):
        """Probe + probed-bucket scan + select, one jitted device dispatch
        (see ``_ivf_search``).

        ``nprobe`` = per-query probe votes; ``nscan`` = batch-shared
        scanned buckets (default ``4 * nprobe``, capped at the bucket
        count — at Q=1 the union IS the query's own probes; wider batches
        naturally widen it). ``method`` ("exact" or "approx") and
        ``recall_target`` are accepted for interface parity: selection is
        exact either way (``ops.topk``). ``scan`` is
        "auto" or "compact" (the same gathered scan); "indexed", an
        in-place scan of the selected buckets, has no GPU implementation
        yet (ROADMAP "Removed, worth writing again for Hopper") and
        raises. Each distinct (k, nprobe, nscan, method) compiles once."""
        q, eq_inner = equery
        nb = self.metadata.nbuckets
        p = min(int(nprobe or self.metadata.nprobe), nb)
        if p < 1 or nb == 0:
            raise ArgumentsError("empty index or nprobe < 1")
        _check_scan(scan)
        _check_method(method)
        if nscan is None:
            nscan = self.metadata.nscan
        u = min(int(nscan) if nscan else 4 * p, nb)
        u = max(u, p)
        kk2 = min(
            max(2 * int(k), int(k) * self._max_dup),
            u * self.metadata.bucket_size,
        )
        kind = self.metadata.kind
        eq, inner = self._family_arrays(eq_inner)
        resid = None
        if self.metadata.residual:
            resid = (
                (self._corr_scale_dev, self._resid_pq)
                if kind == "pq"
                else (self._corr_scale_dev,)
            )
        return _ivf_search(
            q, eq, self._means_dev, self._slot_ids_dev, inner, resid,
            kind=kind, k=int(k), p=p, u=u,
            dt=self.params.distance_type, invert=self.params.invert,
            s=self.metadata.bucket_size, dim=self.params.dim, kk2=kk2,
            pq_transposed=(kind == "pq" and self.quantizer._codes is None),
        )

    def top_k(
        self, equery, k: int, method: str = "exact",
        nprobe: Optional[int] = None, nscan: Optional[int] = None,
        scan: str = "auto", recall_target: Optional[float] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        sv, ids = self.top_k_device(
            equery, k, method=method, nprobe=nprobe, nscan=nscan, scan=scan,
            recall_target=recall_target,
        )
        return np.asarray(sv), np.asarray(ids)

    # ----------------------------------------------------------- storage
    def save(self, data_path, meta_path) -> None:
        """Four files: the inner quantizer's own (data_path, meta_path)
        pair plus ``<data_path>.ivf`` (bucket_ids + bucket_means, raw
        little-endian bytes) and ``<meta_path>.ivf.json``.

        For non-residual indexes the inner pair is loadable standalone
        as a plain full-scan index over the permuted padded corpus. For
        RESIDUAL indexes it is format-valid but scores residuals
        ``v - bucket_center`` under DOT parameters, NOT the corpus —
        reusing those two files without the ``.ivf`` sidecars gives
        meaningless scores. Residual indexes still need nothing extra
        saved: their effective arrays are re-derived from codes + means
        at load (_init_residual)."""
        self.quantizer.save(data_path, meta_path)
        with open(f"{os.fspath(meta_path)}.ivf.json", "w") as f:
            json.dump(self.metadata.to_json(), f)
        with open(f"{os.fspath(data_path)}.ivf", "wb") as f:
            f.write(self.bucket_ids.astype("<i4").tobytes())
            f.write(self.bucket_means.astype("<f4").tobytes())

    @classmethod
    def load(
        cls, data_path, meta_path, params: VectorParameters
    ) -> "IVFIndex":
        """``params`` describes the ORIGINAL corpus (count = N); the inner
        quantizer is loaded with the padded count from the IVF meta (and,
        for residual indexes, the inner DOT scoring parameters — the
        outer metric is reconstructed by dot-expansion, _init_residual)."""
        try:
            with open(f"{os.fspath(meta_path)}.ivf.json") as f:
                meta = IVFMetadata.from_json(json.load(f))
        except (OSError, KeyError, ValueError) as e:
            raise StorageIOError(f"cannot read IVF metadata: {e}") from e
        b, s, d = meta.nbuckets, meta.bucket_size, params.dim
        if meta.residual:
            inner_params = VectorParameters(
                params.dim, b * s, DistanceType.DOT, False
            )
        else:
            inner_params = VectorParameters(
                params.dim, b * s, params.distance_type, params.invert
            )
        inner = _registry()[meta.kind].load(
            data_path, meta_path, inner_params
        )
        sizes = (b * s * 4, b * d * 4)
        try:
            with open(f"{os.fspath(data_path)}.ivf", "rb") as f:
                blob = f.read()
        except OSError as e:
            raise StorageIOError(f"cannot read IVF data: {e}") from e
        if len(blob) != sum(sizes):
            raise StorageIOError(
                f"IVF blob size {len(blob)} != expected {sum(sizes)}"
            )
        ids = np.frombuffer(blob[: sizes[0]], "<i4").reshape(b, s)
        means = np.frombuffer(blob[sizes[0] :], "<f4").reshape(b, d)
        return cls(inner, ids, means, meta)
