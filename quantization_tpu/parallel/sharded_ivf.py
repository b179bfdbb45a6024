"""ShardedIVF — probe-limited IVF search over a device mesh.

Combines the engine's two scaling mechanisms: the corpus is clustered
into buckets (``models/ivf.py``) AND the bucket axis is sharded over the
mesh's ``shard`` axis, so a search scans only the probed fraction of the
rows and each chip scans only its own buckets. This is the >100M-row
serving shape: each device's memory holds N/shards rows of codes, per-query work
is the probed fraction of that, and the only collective is one
``all_gather`` of (kk scores, kk global ids) per shard (the same tail as
the full-scan sharded classes, parallel/sharded.py).

The class is fully sharded-native end to end — nothing in its lifecycle
materializes the corpus, the code array, or a second layout on one
host/chip:

  * ``ShardedIVF.encode`` streams host batches: centers are trained on a
    <=262k-row sample, every batch is assigned + inner-encoded on device
    and committed straight to its rows' final bucket slots in per-shard
    buffers (``DeviceScatter`` — the scatter is GSPMD-lowered to a masked
    per-shard update). The counterpart of the reference's injectable
    storage seam (encoded_storage.rs:7-25) + iterator encode
    (encoded_vectors_u8.rs:34-39).
  * ``ShardedIVF.load`` reads the four-file checkpoint shard by shard:
    each device's slice of the inner blob is gathered through a memory
    map inside its ``make_array_from_callback`` callback.
  * ``ShardedIVF.save`` writes the same four-file format as
    ``IVFIndex.save`` (bidirectional with the single-device class — the
    sharding is a runtime layout, not a storage property), blob written
    shard by shard in the blob's ORIGINAL bucket order.
  * ``ShardedIVF(ivf, mesh)`` still wraps an already-built single-device
    ``IVFIndex`` (fine when the corpus fits one chip); the wrapped index
    is NOT kept — its arrays are re-laid and the reference dropped.

Design notes (no reference counterpart — the reference's
parallelism is intra-process rayon threading, SURVEY.md §2):

* **Round-robin bucket placement.** ``build_buckets`` lays buckets out
  cluster-major, so contiguous block sharding would put whole clusters
  on one chip and a query batch aimed at few clusters would stall on one
  shard. Buckets are therefore re-ordered at construction so shard ``s``
  owns original buckets ``{b : b % n_shards == s}`` — every cluster's
  buckets spread across the mesh and the per-shard probe load stays
  balanced for any query mix.
* **Per-shard union quota.** Each shard runs the same rank-fair priority
  (``_bucket_priority`` — replicated math over the replicated bucket
  means) but selects its top ``ceil(nscan / n_shards)`` buckets among
  the buckets IT OWNS. Total scanned width >= nscan, work is exactly
  balanced, and no bucket list crosses the wire. With ``nscan >= the
  bucket count`` every bucket is scanned and the result equals the
  full-scan sharded search.
* **Pad buckets duplicate real buckets.** The bucket count is padded to
  a multiple of the shard count with COPIES of real buckets (real codes,
  real slot ids), so a pad bucket that wins a union slot costs only
  wasted work — the final id-dedupe removes the copies. The dedupe
  margin accounts for the extra copy (``_max_dup + 1``).
"""

from __future__ import annotations

import json
import os
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.interface import iter_batches
from ..core.types import (
    ArgumentsError,
    DistanceType,
    StorageIOError,
    VectorParameters,
    check_stop,
)
from ..models.bq import BQMetadata, EncodedQueryBin
from ..models.ivf import (
    NEG,
    IVFIndex,
    IVFMetadata,
    auto_geometry as _auto_geometry,
    _bucket_priority,
    _dedupe_select,
    _check_method,
    _check_scan,
    _derive_slot_ids,
    _residual_coeffs,
    _residual_query_bq,
    _residual_query_pq,
    _residual_query_sq,
    _scan_buckets_compact,
    _union_bucket_term,
)
from ..models.pq import EncodedQueryPQ, PQMetadata, ProductQuantizer
from ..models.sq import EncodedQueryU8, SQMetadata, calibrate_sq
from ..ops import bq as bq_ops
from ..ops import ivf as ivf_ops
from ..ops import pq as pq_ops
from ..ops import sq as sq_ops
from ..utils.device_store import DeviceScatter
from .sharded import _word_pad, make_mesh


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "axis", "kind", "k", "p", "u_loc", "b_loc", "dt",
        "invert", "s", "dim", "kk2",
    ),
)
def _ivf_sharded_search(
    q, eq, means, slot_ids, inner, resid=None,
    *, mesh, axis, kind, k, p, u_loc, b_loc, dt, invert, s, dim, kk2,
):
    """One-dispatch sharded IVF search: replicated probe/priority, local
    top-``u_loc`` bucket quota per shard, per-shard compact scan (models/
    ivf.py ``_scan_buckets_compact``), one tiled all_gather, replicated
    dedupe.

    ``resid`` (residual indexes): ``(corr_scale,)`` for SQ or
    ``(corr_scale, rowadd)`` for PQ — the bucket term corr_scale *
    (q . c_b) is computed per shard UNION-FIRST against the replicated
    (reordered) means (only the shard's scanned buckets' columns, see
    models/ivf.py _ivf_search); ``rowadd`` arrives already
    bucket-sharded (one slice per shard inside shard_map)."""
    nq = q.shape[0]

    def local(q, eq, means, sid_loc, inner, resid):
        prio = _bucket_priority(q, means, dt, invert, p)  # [B_pad], repl.
        sidx = jax.lax.axis_index(axis)
        my = jax.lax.dynamic_slice(prio, (sidx * b_loc,), (b_loc,))
        _, union_loc = jax.lax.top_k(my, u_loc)  # LOCAL bucket indices
        corr = rowadd_loc = None
        if resid is not None:
            # Global bucket index = shard offset + local union.
            corr = _union_bucket_term(
                q, jnp.take(means, sidx * b_loc + union_loc, axis=0),
                resid[0], kind, dt, invert,
            )
            if len(resid) > 1:
                rowadd_loc = resid[1]  # this shard's [b_loc*s] slice
        sv, loc = _scan_buckets_compact(
            kind, eq, inner, union_loc, nb=b_loc, s=s, dt=dt,
            invert=invert, dim=dim, kk2=kk2, corr=corr, rowadd=rowadd_loc,
        )
        gids = jnp.take(sid_loc, union_loc, axis=0).reshape(-1)
        out_ids = jnp.where(
            loc >= 0, jnp.take(gids, jnp.maximum(loc, 0)), -1
        )
        sv = jnp.where(loc >= 0, sv, NEG)
        sv_all = jax.lax.all_gather(sv, axis, axis=1, tiled=True)
        ids_all = jax.lax.all_gather(out_ids, axis, axis=1, tiled=True)
        return sv_all, ids_all

    # Query-side operands are replicated whatever their count (SQ: codes
    # + offsets; BQ: packed planes, or the residual (codes, mult, qb)
    # affine triple; PQ: LUT).
    eq_spec = tuple(P() for _ in eq)
    if kind == "sq":
        inner_spec = (P(axis, None), P(axis), P())
    elif kind == "bq":
        inner_spec = (P(None, axis),)
    else:  # pq
        inner_spec = (P(axis, None),)
    if resid is None:
        resid_spec = None
    elif len(resid) > 1:
        resid_spec = (P(), P(axis))
    else:
        resid_spec = (P(),)

    sv_all, ids_all = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), eq_spec, P(), P(axis, None), inner_spec, resid_spec),
        out_specs=(P(), P()),
        check_vma=False,
    )(q, eq, means, slot_ids, inner, resid)
    return _dedupe_select(sv_all, ids_all, nq, k, sv_all.shape[1])


def _round_robin_layout(b: int, ns: int):
    """``(old, is_primary, b_loc, b_pad)``: shard ``sh`` owns NEW bucket
    positions ``[sh*b_loc, (sh+1)*b_loc)`` holding ORIGINAL buckets
    ``sh, sh+ns, sh+2*ns, ...``; positions whose pre-wrap index is past
    ``b`` are pad buckets — COPIES of real buckets (``old`` wraps;
    ``is_primary`` marks the one canonical position of each original
    bucket)."""
    b_loc = -(-b // ns)
    b_pad = b_loc * ns
    pre = np.concatenate([np.arange(sh, b_pad, ns) for sh in range(ns)])
    return pre % b, pre < b, b_loc, b_pad


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "axis", "b_loc", "s", "dim", "alpha", "offset", "rowcoef",
    ),
)
def _sq_rowterm_sharded(
    codes, pad, means, *, mesh, axis, b_loc, s, dim, alpha, offset, rowcoef
):
    """Per-shard derivation of the residual-SQ search voffsets: squared
    norms of the DECODED points |c_b + r^|^2 (see ops/ivf.py
    sq_decoded_rowterm for why the decoded norm), NEG at pad slots.
    Each shard computes its own b_loc buckets against its slice of the
    replicated means — the code array never leaves its shard."""

    def local(c_loc, p_loc, means_rep):
        sidx = jax.lax.axis_index(axis)
        m_loc = jax.lax.dynamic_slice(
            means_rep, (sidx * b_loc, 0), (b_loc, means_rep.shape[1])
        )
        if rowcoef == 0.0:
            rt = jnp.zeros((b_loc * s,), jnp.float32)
        else:
            def per_bucket(args):
                cb, mb = args  # [s, lane], [dim]
                v = cb[:, :dim].astype(jnp.float32) * alpha + offset
                vhat = v + mb[None, :]
                return jnp.sum(vhat * vhat, axis=1)

            rt = rowcoef * jax.lax.map(
                per_bucket, (c_loc.reshape(b_loc, s, -1), m_loc)
            ).reshape(b_loc * s)
        return jnp.where(p_loc, NEG, rt)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis), P()),
        out_specs=P(axis),
        check_vma=False,
    )(codes, pad, means)


@partial(
    jax.jit,
    static_argnames=("mesh", "axis", "b_loc", "s", "division", "rowcoef"),
)
def _pq_rowterm_sharded(
    codes, pad, means, c_chunks, rot, *, mesh, axis, b_loc, s, division,
    rowcoef,
):
    """PQ twin of ``_sq_rowterm_sharded`` (≙ ops/ivf.py
    pq_decoded_rowterm, per shard): |c_b + r^|^2 with r^ the rows' chunk
    centroids, gathered per bucket from the tiny replicated codebook."""
    m = len(division)

    def local(c_loc, p_loc, means_rep, cc, r):
        sidx = jax.lax.axis_index(axis)
        m_loc = jax.lax.dynamic_slice(
            means_rep, (sidx * b_loc, 0), (b_loc, means_rep.shape[1])
        )
        if rowcoef == 0.0:
            rt = jnp.zeros((b_loc * s,), jnp.float32)
        else:
            cent_norm = jnp.sum(cc * cc, axis=2)  # [m, k]

            hp = jax.lax.Precision.HIGHEST  # data-scale terms (ops/ivf.py)

            def per_bucket(args):
                cb, mrow = args  # [s, m], [dim]
                mr1 = (
                    mrow if r is None
                    else jnp.matmul(mrow, r, precision=hp)
                )
                mc = pq_ops.chunk_rows_device(
                    mr1[None, :], list(division)
                )[:, 0, :]  # [m, dmax]
                t2b = 2.0 * jnp.einsum(
                    "md,mkd->mk", mc, cc,
                    preferred_element_type=jnp.float32, precision=hp,
                ) + cent_norm
                g = jnp.take_along_axis(
                    t2b, cb.T.astype(jnp.int32), axis=1
                )  # [m, s]
                return jnp.sum(g, axis=0) + jnp.sum(mrow * mrow)

            rt = rowcoef * jax.lax.map(
                per_bucket, (c_loc.reshape(b_loc, s, m), m_loc)
            ).reshape(b_loc * s)
        return jnp.where(p_loc, NEG, rt)

    rot_spec = None if rot is None else P()
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(), P(), rot_spec),
        out_specs=P(axis),
        check_vma=False,
    )(codes, pad, means, c_chunks, rot)


class ShardedIVF:
    """IVF index with its bucket axis sharded over a device mesh.

    Three construction paths — streaming sharded-native ``encode``,
    per-shard ``load``, or wrapping a built single-device ``IVFIndex``
    (see module docstring). All state is either per-shard (inner code
    arrays, slot ids, residual row terms) or small-replicated (bucket
    means — the probe targets every chip ranks — plus codebook-sized
    query metadata); no full second layout is kept live.
    """

    def __init__(
        self,
        ivf: IVFIndex,
        mesh: Optional[Mesh] = None,
        axis: str = "shard",
    ):
        """Wrap (re-lay) a built single-device index. The wrapped object
        is not retained — its arrays move under the sharded layout and
        query-side metadata is copied out."""
        mesh = mesh if mesh is not None else make_mesh()
        meta = ivf.metadata
        b, s = meta.nbuckets, meta.bucket_size
        old, _, _, b_pad = _round_robin_layout(b, int(mesh.shape[axis]))

        means_new = np.asarray(ivf.bucket_means, np.float32)[old]
        slot_ids_new = np.asarray(ivf._slot_ids_dev).reshape(b, s)[old]
        ridx = (old[:, None] * s + np.arange(s)[None, :]).reshape(-1)

        kind = meta.kind
        qz = ivf.quantizer
        spec2 = NamedSharding(mesh, P(axis, None))
        spec1 = NamedSharding(mesh, P(axis))
        inner = voff_inner = rowadd = None
        if kind == "sq":
            codes = jax.device_put(np.asarray(qz.codes)[ridx], spec2)
            # Residual indexes: the per-row term is the derived
            # |decoded|^2-or-NEG array, not the inner DOT voffsets
            # (models/ivf.py _init_residual); the multiplier is the
            # per-query traced column and joins the tuple at call time.
            voff = np.asarray(
                ivf._resid_sq if meta.residual else qz.voffsets
            )[ridx]
            inner = (codes, jax.device_put(voff, spec1))
            if meta.residual:
                voff_inner = jax.device_put(
                    np.asarray(qz.voffsets)[ridx], spec1
                )
        elif kind == "bq":
            inner = (
                jax.device_put(
                    np.asarray(qz.planes)[:, ridx],
                    NamedSharding(mesh, P(None, axis)),
                ),
            )
        else:  # pq
            inner = (
                jax.device_put(
                    np.asarray(qz.codes[:, : qz.num_chunks])[ridx], spec2
                ),
            )
            if meta.residual:
                rowadd = jax.device_put(
                    np.asarray(ivf._resid_pq)[ridx], spec1
                )
        self._init_from_parts(
            mesh=mesh,
            axis=axis,
            metadata=meta,
            inner_meta=qz.metadata,
            bucket_ids=ivf.bucket_ids,
            bucket_means=ivf.bucket_means,
            means_new=means_new,
            slot_ids_new=slot_ids_new,
            inner=inner,
            voff_inner=voff_inner,
            rowadd=rowadd,
            max_dup=ivf._max_dup + (1 if b_pad > b else 0),
            store_type=getattr(qz, "store_type", "u128"),
        )

    def _init_from_parts(
        self, *, mesh, axis, metadata, inner_meta, bucket_ids, bucket_means,
        means_new, slot_ids_new, inner, voff_inner, rowadd, max_dup,
        store_type="u128",
    ):
        self.mesh = mesh
        self.axis = axis
        self.metadata = metadata
        self.params = metadata.vector_parameters
        self.inner_meta = inner_meta
        self.n_shards = int(mesh.shape[axis])
        b = metadata.nbuckets
        (
            self._old, self._is_primary, self._b_loc, self._b_pad,
        ) = _round_robin_layout(b, self.n_shards)
        self._max_dup = max_dup
        # Host copies in ORIGINAL bucket order (the storage layout — the
        # round-robin relay is runtime-only): id mask + probe means.
        self.bucket_ids = np.asarray(bucket_ids, np.int32)
        self.bucket_means = np.asarray(bucket_means, np.float32)
        if isinstance(means_new, jax.Array):
            self._means_dev = means_new
        else:
            self._means_dev = jax.device_put(
                np.asarray(means_new, np.float32), NamedSharding(mesh, P())
            )
        if metadata.residual and metadata.kind == "bq":
            # Residual-BQ: mask within-bucket pad slots (id -> -1), same
            # rule as IVFIndex.__init__ — cross-bucket pad duplicates are
            # invalid residual estimators and the plane layout has no
            # per-slot additive to poison them with.
            slot_ids_new = np.where(
                self.bucket_ids[self._old] >= 0,
                np.asarray(slot_ids_new, np.int32), -1,
            )
        if isinstance(slot_ids_new, jax.Array):
            self._slot_ids_dev = slot_ids_new
        else:
            self._slot_ids_dev = jax.device_put(
                np.asarray(slot_ids_new, np.int32),
                NamedSharding(mesh, P(axis, None)),
            )
        self._inner = inner
        self._voff_inner = voff_inner  # residual SQ: inner DOT voffsets
        self._rowadd_dev = rowadd  # residual PQ: per-slot additive
        kind = metadata.kind
        if kind == "sq":
            self._mult_dev = jnp.float32(inner_meta.multiplier)
        elif kind == "pq":
            self._c_chunks = jnp.asarray(
                pq_ops.centroids_to_chunks(
                    np.asarray(inner_meta.centroids),
                    inner_meta.vector_division,
                )
            )
            self._rot = (
                None
                if inner_meta.rotation is None
                else jnp.asarray(inner_meta.rotation, jnp.float32)
            )
        else:
            self._store_type = store_type
        if metadata.residual:
            a, rc = _residual_coeffs(
                self.params.distance_type, self.params.invert
            )
            self._res_a, self._res_rowcoef = a, rc
            self._corr_scale_dev = jnp.float32(a)

    # ------------------------------------------------------------- build
    @classmethod
    def encode(
        cls,
        data,
        params: VectorParameters,
        *,
        mesh: Optional[Mesh] = None,
        axis: str = "shard",
        quantizer: str = "sq",
        nlist: Optional[int] = None,
        bucket_size: Optional[int] = None,
        nprobe: int = 32,
        nscan: Optional[int] = None,
        seed: int = 0,
        residual: bool = False,
        stop_condition=None,
        batch_size: int = 65536,
        **quantizer_kwargs,
    ) -> "ShardedIVF":
        """Sharded-native streaming build — the corpus and its codes never
        materialize on one host or chip.

        ``data`` may be an array OR a re-iterable stream factory (unlike
        ``IVFIndex.encode``, which permutes a materialized array). The
        build makes a handful of passes over the stream:

          1. sample <=262k rows (``sample_rows``) and train the coarse
             centers (≙ IVFIndex.encode's sampled k-means);
          2. assign every row to its center on device, batch by batch —
             only the i32 assignment vector lives on the host;
          3. build the bucket layout from the assignments
             (``build_buckets``) and precompute each row's final slot in
             the round-robin-sharded layout;
          4. train/calibrate the inner quantizer over the stream (SQ
             min/max + quantile; PQ sampled k-means; residual variants
             see ``v - bucket_mean`` via a residualizing wrapper);
          5. encode each batch on device and scatter the codes straight
             to their slots in the per-shard buffers (``DeviceScatter``);
             bucket-mean sums accumulate on device in the same pass
             (for residual indexes the means get their own pass — they
             must precede residualization);
          6. fill duplicate slots (pads + round-robin pad buckets) with
             one on-device gather+scatter; derive residual row terms per
             shard (``_sq_rowterm_sharded`` / ``_pq_rowterm_sharded``).

        Kwargs pass through to the inner family: ``quantile`` (SQ),
        ``chunk_size``/``bits``/``rotation`` (PQ), ``store_type`` (BQ).
        Constraint set matches ``IVFIndex.encode`` (models/ivf.py).

        Build-host memory requirement: the bucket-layout step (step 3)
        is host-sided and needs ~24 B/row at peak (argsort transient;
        2.4 GB at 100M rows, 24 GB at 1B), ~16 B/row steady through the
        encode pass. This is a BUILD-time cost on the build host only —
        per-shard ``load`` reconstructs serving state without any of it.
        """
        mesh = mesh if mesh is not None else make_mesh()
        ns = int(mesh.shape[axis])
        if quantizer not in ("sq", "pq", "bq"):
            # Accept the model classes like IVFIndex.encode does.
            from ..models.ivf import _registry

            kind = next(
                (
                    kk for kk, c in _registry().items()
                    if c is quantizer
                ),
                None,
            )
            if kind is None:
                raise ArgumentsError(
                    f"quantizer must be 'sq' | 'pq' | 'bq' or a quantizer "
                    f"class, got {quantizer!r}"
                )
        else:
            kind = quantizer
        if params.count < 1:
            raise ArgumentsError("ShardedIVF needs a non-empty corpus")
        # Geometry defaults mirror IVFIndex.encode (auto_geometry rules).
        if bucket_size is None:
            bucket_size = _auto_geometry(params.count, residual)[1]
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
        n, dim, s = params.count, params.dim, int(bucket_size)

        def batches():
            return iter_batches(data, batch_size)

        # 1. sample + coarse centers (reference-free: SURVEY.md §2 has no
        # IVF; the sampling caps mirror IVFIndex.encode).
        from ..ops.quantile import sample_rows

        check_stop(stop_condition)
        sample_n = min(
            n,
            max(nlist, ivf_ops.IVF_SAMPLE_PER_CENTER * nlist),
            ivf_ops.sample_cap(nlist),
        )
        sample = sample_rows(batches, n, sample_n, seed)
        if sample.shape[0] and sample.shape[1] != dim:
            raise ArgumentsError(
                f"Vector length {sample.shape[1]} does not match vector "
                f"parameters dim {dim}"
            )
        centers = ivf_ops.train_centers(
            sample, nlist, seed=seed, stop_condition=stop_condition
        )

        # 2. streaming assignment (device argmin per batch).
        centers_d = jnp.asarray(centers, jnp.float32)
        cc = jnp.sum(centers_d * centers_d, axis=1)

        @jax.jit
        def _assign(x):
            return jnp.argmin(
                cc[None, :] - 2.0 * (x @ centers_d.T), axis=1
            ).astype(jnp.int32)

        assignments = np.empty((n,), np.int32)
        r0 = 0
        for batch in batches():
            check_stop(stop_condition)
            if batch.shape[1] != dim:
                raise ArgumentsError(
                    f"Vector length {batch.shape[1]} does not match "
                    f"vector parameters dim {dim}"
                )
            if r0 + batch.shape[0] > n:
                raise ArgumentsError(
                    f"Vector count exceeds vector parameters count {n}"
                )
            assignments[r0 : r0 + batch.shape[0]] = np.asarray(
                _assign(jnp.asarray(batch, jnp.float32))
            )
            r0 += batch.shape[0]
        if r0 != n:
            raise ArgumentsError(
                f"Vector count {r0} does not match vector parameters "
                f"count {n}"
            )

        # 3. bucket layout + slot mapping in the final sharded order.
        #
        # Build-host memory: this is the one deliberately host-sided step
        # (the layout is a permutation problem, not a compute one). Peak
        # is ~24 B/row inside build_buckets' argsort (2.4 GB at 100M,
        # 24 GB at 1B rows on the BUILD host only — serving loads need
        # none of it); steady state below is ~16 B/row (slot_of_row i32 +
        # bucket_new_of_row i32 + bucket_ids/slot_ids i32 per slot).
        # README's capacity claim states this requirement.
        perm, bucket_ids = ivf_ops.build_buckets(assignments, s)
        del assignments, perm  # perm is the materialized-array path's tool
        b = bucket_ids.shape[0]
        old, is_primary, b_loc, b_pad = _round_robin_layout(b, ns)
        slot_ids_orig, max_dup = _derive_slot_ids(bucket_ids, n)
        slot_ids_new = slot_ids_orig[old]
        del slot_ids_orig
        flat_ids = bucket_ids[old].reshape(-1)
        prim_mask = np.repeat(is_primary, s) & (flat_ids >= 0)
        # i32 slots are exact below 2^31 slots (~2.1B rows + pads); the
        # dtype flips itself for anything bigger.
        slot_dt = (
            np.int64 if int(b_pad) * s > np.iinfo(np.int32).max
            else np.int32
        )
        slot_of_row = np.empty((n,), slot_dt)
        slot_of_row[flat_ids[prim_mask]] = np.flatnonzero(prim_mask)
        # Duplicate slots (pads within real buckets + whole pad buckets):
        # filled after the scatter pass by copying each duplicated row's
        # code from its primary slot.
        fill_dst = np.flatnonzero(~prim_mask)
        fill_src = slot_of_row[slot_ids_new.reshape(-1)[fill_dst]]
        if residual:
            # Original-order bucket of each row (residualization pass).
            oflat = bucket_ids.reshape(-1)
            omask = oflat >= 0
            bucket_of_row = np.empty((n,), np.int32)
            bucket_of_row[oflat[omask]] = (
                np.flatnonzero(omask) // s
            ).astype(np.int32)
            del oflat, omask
        pad_mask = flat_ids < 0  # residual row-term masking (1 B/slot)
        del prim_mask, flat_ids
        bucket_new_of_row = (slot_of_row // s).astype(np.int32)
        if b_pad > b:
            max_dup += 1

        # Bucket-mean accumulation (device scatter-add, NEW bucket order;
        # per-shard storage like everything else).
        mean_spec = NamedSharding(mesh, P(axis, None))
        cnt_spec = NamedSharding(mesh, P(axis))
        msum = DeviceScatter((b_pad, dim), jnp.float32, sharding=mean_spec)
        mcnt = DeviceScatter((b_pad,), jnp.float32, sharding=cnt_spec)

        def _acc_means(xb, r0, bsz):
            bidx = bucket_new_of_row[r0 : r0 + bsz]
            msum.add(xb, bidx)
            mcnt.add(jnp.ones((bsz,), jnp.float32), bidx)

        means_orig = None  # set before any residual pass / at finalize

        def _finalize_means():
            sums = np.asarray(msum.finish())
            cnts = np.asarray(mcnt.finish())
            means_new = sums / np.maximum(cnts, 1.0)[:, None]
            mo = np.empty((b, dim), np.float32)
            mo[old[is_primary]] = means_new[is_primary]
            return mo

        if residual:
            # Means need their own pass: residualization depends on them.
            r0 = 0
            for batch in batches():
                check_stop(stop_condition)
                bsz = batch.shape[0]
                _acc_means(jnp.asarray(batch, jnp.float32), r0, bsz)
                r0 += bsz
            means_orig = _finalize_means()

            def enc_batches():
                rr = [0]

                def gen():
                    for batch in batches():
                        bsz = batch.shape[0]
                        out = np.asarray(batch, np.float32) - means_orig[
                            bucket_of_row[rr[0] : rr[0] + bsz]
                        ]
                        rr[0] += bsz
                        yield out

                rr[0] = 0
                return gen()

            inner_dt, inner_inv = DistanceType.DOT, False
        else:
            enc_batches = batches
            inner_dt, inner_inv = (
                params.distance_type, params.invert,
            )

        inner_vp = VectorParameters(dim, b * s, inner_dt, inner_inv)
        train_vp = VectorParameters(dim, n, inner_dt, inner_inv)

        # 4. inner training / calibration over the (residualized) stream.
        spec2 = NamedSharding(mesh, P(axis, None))
        spec1 = NamedSharding(mesh, P(axis))
        if kind == "sq":
            quantile = quantizer_kwargs.pop("quantile", None)
            if quantizer_kwargs:
                raise ArgumentsError(
                    f"unknown SQ kwargs {sorted(quantizer_kwargs)}"
                )
            alpha, offset = calibrate_sq(
                enc_batches, train_vp, quantile, stop_condition, seed
            )
            actual = sq_ops.actual_dim(dim)
            lane = actual + (-actual) % sq_ops.LANE
            multiplier = sq_ops.multiplier_for(inner_dt, inner_inv, alpha)
            inner_meta = SQMetadata(
                actual, alpha, offset, multiplier, inner_vp
            )
            codes_st = DeviceScatter(
                (b_pad * s, lane), jnp.int8, sharding=spec2
            )
            voff_st = DeviceScatter((b_pad * s,), jnp.float32, sharding=spec1)

            def enc_commit(xb, slots):
                cb, vb = sq_ops.quantize_batch(
                    xb, alpha=alpha, offset=offset,
                    distance_type=inner_dt, invert=inner_inv,
                    dpad=actual, lane=lane,
                )
                codes_st.scatter(cb, slots)
                voff_st.scatter(vb, slots)

        elif kind == "pq":
            if "chunk_size" not in quantizer_kwargs:
                raise ArgumentsError("PQ inner quantizer needs chunk_size")
            chunk_size = quantizer_kwargs.pop("chunk_size")
            bits = quantizer_kwargs.pop("bits", 8)
            rotation = quantizer_kwargs.pop("rotation", None)
            if quantizer_kwargs:
                raise ArgumentsError(
                    f"unknown PQ kwargs {sorted(quantizer_kwargs)}"
                )
            if bits not in (4, 8):
                raise ArgumentsError(f"bits must be 4 or 8, got {bits}")
            division = pq_ops.get_vector_division(dim, chunk_size)
            kc = (
                pq_ops.CENTROIDS_COUNT if bits == 8
                else pq_ops.CENTROIDS_COUNT4
            )
            centroids, rot = ProductQuantizer._find_centroids(
                enc_batches, division, train_vp, stop_condition, seed, kc,
                rotation=rotation,
            )
            rot_j = None if rot is None else jnp.asarray(rot)
            c_chunks = jnp.asarray(
                pq_ops.centroids_to_chunks(centroids, division)
            )
            inner_meta = PQMetadata(
                centroids, division, inner_vp, bits=bits, rotation=rot
            )
            m = len(division)
            codes_st = DeviceScatter(
                (b_pad * s, m), jnp.uint8, sharding=spec2
            )

            def enc_commit(xb, slots):
                if rot_j is not None:
                    x_chunks = pq_ops.chunk_rows_device(xb @ rot_j, division)
                else:
                    x_chunks = pq_ops.chunk_rows_device(xb, division)
                codes_st.scatter(
                    pq_ops.encode_batch(x_chunks, c_chunks), slots
                )

        else:  # bq
            store_type = quantizer_kwargs.pop("store_type", "u128")
            if quantizer_kwargs:
                raise ArgumentsError(
                    f"unknown BQ kwargs {sorted(quantizer_kwargs)}"
                )
            row_bytes = bq_ops.storage_bytes(dim, store_type)
            wpad = _word_pad(row_bytes)
            inner_meta = BQMetadata(inner_vp)
            codes_st = DeviceScatter(
                (wpad, b_pad * s), jnp.uint32,
                sharding=NamedSharding(mesh, P(None, axis)), axis=1,
            )
            # beta = E|r_i| over the WHOLE residual stream (the
            # single-device build samples <=262k rows; the stream pass
            # is already paying the host transfer here, so the full
            # mean is free) — maps the asymmetric estimator's sign
            # units back to data units (models/ivf.py _ResidualQueryBQ).
            beta_acc = [0.0, 0]

            def enc_commit(xb, slots):
                # ``xb`` is the SOURCE batch (host numpy for the residual
                # stream; whatever ``batches()`` yields otherwise) — the
                # bit pack below is host-side, so a device copy would
                # only be copied back.
                xn = np.asarray(xb, np.float32)
                if residual:
                    beta_acc[0] += float(np.sum(np.abs(xn)))
                    beta_acc[1] += xn.size
                planes = bq_ops.rows_to_planes(
                    bq_ops.pack_rows(xn, row_bytes)
                )
                if planes.shape[0] < wpad:
                    planes = np.pad(
                        planes, ((0, wpad - planes.shape[0]), (0, 0))
                    )
                codes_st.scatter(jnp.asarray(planes), slots)

        # 5. streaming encode: each batch lands at its final slots. BQ
        # packs bits on the HOST, so it gets the source batch as-is (no
        # upload-then-download per batch — ~1,500 needless full-batch
        # transfers at 100M rows); SQ/PQ encode on device and take the uploaded copy, which
        # _acc_means shares when bucket means still need accumulating.
        r0 = 0
        for batch in enc_batches():
            check_stop(stop_condition)
            bsz = batch.shape[0]
            need_dev = kind != "bq" or not residual
            xb = jnp.asarray(batch, jnp.float32) if need_dev else None
            enc_commit(
                batch if kind == "bq" else xb,
                slot_of_row[r0 : r0 + bsz].astype(np.int32),
            )
            if not residual:
                _acc_means(xb, r0, bsz)
            r0 += bsz

        # 6. fill duplicate slots from their primary rows, finalize.
        codes_st.fill_from(fill_dst, fill_src)
        codes = codes_st.finish()
        voff_inner = rowadd = None
        if kind == "sq":
            voff_st.fill_from(fill_dst, fill_src)
            voff = voff_st.finish()
            inner = (codes, voff)
        else:
            inner = (codes,)
        if means_orig is None:
            means_orig = _finalize_means()
        means_new = means_orig[old]
        means_dev = jax.device_put(means_new, NamedSharding(mesh, P()))

        if residual:
            pad_dev = jax.device_put(
                pad_mask, NamedSharding(mesh, P(axis))
            )
            a, rowcoef = _residual_coeffs(
                params.distance_type, params.invert
            )
            if kind == "sq":
                rterm = _sq_rowterm_sharded(
                    codes, pad_dev, means_dev,
                    mesh=mesh, axis=axis, b_loc=b_loc, s=s, dim=dim,
                    alpha=alpha, offset=offset, rowcoef=rowcoef,
                )
                voff_inner = inner[1]
                inner = (codes, rterm)
            elif kind == "pq":
                rowadd = _pq_rowterm_sharded(
                    codes, pad_dev, means_dev, c_chunks,
                    None if rot is None else jnp.asarray(rot),
                    mesh=mesh, axis=axis, b_loc=b_loc, s=s,
                    division=tuple(division), rowcoef=rowcoef,
                )
            # bq: no derived row terms — beta rides the metadata.

        residual_scale = 0.0
        if residual and kind == "bq":
            residual_scale = max(
                beta_acc[0] / max(beta_acc[1], 1), 1e-30
            )
        meta = IVFMetadata(
            nlist=nlist, bucket_size=s, nprobe=nprobe, kind=kind,
            nbuckets=b, vector_parameters=params, nscan=nscan,
            residual=residual, residual_scale=residual_scale,
        )
        obj = cls.__new__(cls)
        obj._init_from_parts(
            mesh=mesh, axis=axis, metadata=meta, inner_meta=inner_meta,
            bucket_ids=bucket_ids, bucket_means=means_orig,
            means_new=means_dev,
            slot_ids_new=slot_ids_new,
            inner=inner, voff_inner=voff_inner, rowadd=rowadd,
            max_dup=max_dup,
            store_type=(store_type if kind == "bq" else "u128"),
        )
        return obj

    # ------------------------------------------------------------- query
    @property
    def count(self) -> int:
        return self.params.count

    def encode_query(self, queries):
        """(q f32 [Q, D], inner encoded query) — query-side state is all
        metadata-sized (SQ affine constants, PQ codebook, BQ word count),
        so no wrapped single-device index is needed (≙
        IVFIndex.encode_query, including the residual dot-expansion
        folds)."""
        q = jnp.asarray(queries, jnp.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != self.params.dim:
            raise ArgumentsError(
                f"query dim {q.shape[1]} != corpus dim {self.params.dim}"
            )
        kind = self.metadata.kind
        im = self.inner_meta
        if not self.metadata.residual:
            if kind == "sq":
                codes, qoff = sq_ops.encode_query_batch(
                    q, alpha=im.alpha, offset=im.offset,
                    distance_type=self.params.distance_type,
                    invert=self.params.invert,
                    dpad=im.actual_dim, lane=self._inner[0].shape[1],
                )
                return q, EncodedQueryU8(codes, qoff)
            if kind == "bq":
                qn = np.asarray(q, np.float32)
                row_bytes = bq_ops.storage_bytes(
                    self.params.dim, self._store_type
                )
                rows = bq_ops.pack_rows(qn, row_bytes)
                pad = (-row_bytes) % 4
                if pad:
                    rows = np.pad(rows, ((0, 0), (0, pad)))
                words = rows.reshape(rows.shape[0], -1, 4).view(np.uint32)
                words = words.reshape(rows.shape[0], -1)
                w8 = self._inner[0].shape[0]
                if words.shape[1] < w8:
                    words = np.pad(
                        words, ((0, 0), (0, w8 - words.shape[1]))
                    )
                return q, EncodedQueryBin(jnp.asarray(words))
            lut = pq_ops.build_lut(
                self._pq_chunk_query(q),
                self._c_chunks,
                distance_type=self.params.distance_type,
                invert=self.params.invert,
            )
            return q, EncodedQueryPQ(lut)
        a, rc = self._res_a, self._res_rowcoef
        if kind == "sq":
            return q, _residual_query_sq(
                q, im.alpha, im.offset, self._inner[0].shape[1], a, rc
            )
        if kind == "bq":
            dp = self._inner[0].shape[0] * 32
            return q, _residual_query_bq(
                q, dp, a, self.metadata.residual_scale
            )
        lut = pq_ops.build_lut(
            self._pq_chunk_query(q),
            self._c_chunks,
            distance_type=DistanceType.DOT,
            invert=False,
        )
        return q, _residual_query_pq(lut, a)

    def _pq_chunk_query(self, q):
        division = self.inner_meta.vector_division
        if self._rot is not None:
            # HIGHEST: query-side rotation at data scale (models/pq.py).
            return pq_ops.chunk_rows_device(
                jnp.matmul(
                    q, self._rot, precision=jax.lax.Precision.HIGHEST
                ),
                division,
            )
        return jnp.asarray(pq_ops.chunk_tensor(np.asarray(q), division))

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
        """Probe + per-shard probed-bucket scan + gather-merge, one jitted
        dispatch. ``nscan`` is the GLOBAL scanned-bucket budget; each
        shard scans ``ceil(nscan / n_shards)`` of its own buckets (see
        module docstring for the quota semantics). ``scan`` follows
        ``IVFIndex.top_k_device``."""
        q, eq_inner = equery
        meta = self.metadata
        nb = meta.nbuckets
        p = min(int(nprobe or meta.nprobe), nb)
        if p < 1 or nb == 0:
            raise ArgumentsError("empty index or nprobe < 1")
        _check_scan(scan)
        _check_method(method)
        if nscan is None:
            nscan = meta.nscan
        u = min(int(nscan) if nscan else 4 * p, nb)
        u = max(u, p)
        u_loc = min(-(-u // self.n_shards), self._b_loc)
        kk2 = min(
            max(2 * int(k), int(k) * self._max_dup),
            u_loc * meta.bucket_size,
        )
        kind = meta.kind
        if kind == "sq":
            eq = (eq_inner.codes, eq_inner.offsets)
            mult = eq_inner.mult if meta.residual else self._mult_dev
            inner = (*self._inner, mult)
        elif kind == "bq":
            # Residual: asymmetric affine query (codes, mult, qb) — the
            # compact scan keys on len(eq) == 3 (models/ivf.py).
            eq = (
                (eq_inner.codes, eq_inner.mult, eq_inner.qb)
                if meta.residual else (eq_inner.planes,)
            )
            inner = self._inner
        else:
            eq = (eq_inner.lut,)
            inner = self._inner
        resid = None
        if meta.residual:
            resid = (
                (self._corr_scale_dev, self._rowadd_dev)
                if kind == "pq"
                else (self._corr_scale_dev,)
            )
        return _ivf_sharded_search(
            q, eq, self._means_dev, self._slot_ids_dev, inner, resid,
            mesh=self.mesh, axis=self.axis, kind=kind, k=int(k),
            p=p, u_loc=u_loc, b_loc=self._b_loc,
            dt=self.params.distance_type, invert=self.params.invert,
            s=meta.bucket_size, dim=self.params.dim, kk2=kk2,
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
        """Same four-file format as ``IVFIndex.save`` (bidirectional with
        the single-device class), with the inner blob written SHARD BY
        SHARD: each device's slice is pulled once and its buckets seek to
        their original-bucket-order file offsets — no single-host gather
        of the code array."""
        meta_dir = os.path.dirname(os.fspath(meta_path))
        if meta_dir:
            os.makedirs(meta_dir, exist_ok=True)
        with open(meta_path, "w") as f:
            json.dump(self.inner_meta.to_json(), f)
        with open(f"{os.fspath(meta_path)}.ivf.json", "w") as f:
            json.dump(self.metadata.to_json(), f)
        with open(f"{os.fspath(data_path)}.ivf", "wb") as f:
            f.write(self.bucket_ids.astype("<i4").tobytes())
            f.write(self.bucket_means.astype("<f4").tobytes())

        meta = self.metadata
        kind, s, b = meta.kind, meta.bucket_size, meta.nbuckets
        im = self.inner_meta

        if kind == "sq":
            row_size = im.actual_dim + 4
            voff_src = (
                self._voff_inner if meta.residual else self._inner[1]
            )
            voffs = {
                (sh.index[0].start or 0): np.asarray(sh.data)
                for sh in voff_src.addressable_shards
            }

            def bucket_rows(data_np, lo, hi, r0):
                rows = np.zeros((hi - lo, row_size), np.uint8)
                rows[:, 4:] = data_np[lo:hi, : im.actual_dim].view(np.uint8)
                rows[:, :4] = (
                    voffs[r0][lo:hi].astype(np.float32)
                    .view(np.uint8).reshape(-1, 4)
                )
                return rows

            arr, axis_dim = self._inner[0], 0
        elif kind == "pq":
            m = len(im.vector_division)
            bits4 = im.bits == 4
            row_size = (m + 1) // 2 if bits4 else m

            def bucket_rows(data_np, lo, hi, r0):
                rows = np.ascontiguousarray(data_np[lo:hi, :m])
                if bits4:
                    if rows.shape[1] % 2:
                        rows = np.pad(rows, ((0, 0), (0, 1)))
                    rows = (
                        rows[:, 0::2] | (rows[:, 1::2] << 4)
                    ).astype(np.uint8)
                return rows

            arr, axis_dim = self._inner[0], 0
        else:  # bq
            row_size = bq_ops.storage_bytes(
                self.params.dim, self._store_type
            )

            def bucket_rows(data_np, lo, hi, r0):
                return bq_ops.planes_to_rows(data_np[:, lo:hi], row_size)

            arr, axis_dim = self._inner[0], 1

        with open(data_path, "wb") as f:
            f.truncate(b * s * row_size)
            seen = set()
            for shard in arr.addressable_shards:
                sl = shard.index[axis_dim]
                r0 = sl.start or 0
                if r0 in seen:
                    continue  # replicated copy on another mesh axis
                seen.add(r0)
                data_np = np.asarray(shard.data)
                nb0 = r0 // s
                n_loc = (
                    data_np.shape[axis_dim] // s
                )
                for lb in range(n_loc):
                    np0 = nb0 + lb
                    if np0 >= self._b_pad or not self._is_primary[np0]:
                        continue
                    ob = int(self._old[np0])
                    rows = bucket_rows(data_np, lb * s, (lb + 1) * s, r0)
                    f.seek(ob * s * row_size)
                    f.write(rows.tobytes())

    @classmethod
    def load(
        cls, data_path, meta_path, params: VectorParameters,
        mesh: Optional[Mesh] = None, axis: str = "shard",
    ) -> "ShardedIVF":
        """Per-shard load of the four-file format: each device's slice of
        the inner blob is read through a memory map inside its
        ``make_array_from_callback`` callback — the code array never
        materializes on one host/chip. Residual row terms are re-derived
        per shard on device (``_*_rowterm_sharded``), exactly as
        ``IVFIndex.load`` re-derives them via ``_init_residual``."""
        mesh = mesh if mesh is not None else make_mesh()
        ns = int(mesh.shape[axis])
        try:
            with open(f"{os.fspath(meta_path)}.ivf.json") as f:
                meta = IVFMetadata.from_json(json.load(f))
        except (OSError, KeyError, ValueError) as e:
            raise StorageIOError(f"cannot read IVF metadata: {e}") from e
        b, s, dim = meta.nbuckets, meta.bucket_size, params.dim
        kind = meta.kind
        sizes = (b * s * 4, b * dim * 4)
        try:
            with open(f"{os.fspath(data_path)}.ivf", "rb") as f:
                blob = f.read()
        except OSError as e:
            raise StorageIOError(f"cannot read IVF data: {e}") from e
        if len(blob) != sum(sizes):
            raise StorageIOError(
                f"IVF blob size {len(blob)} != expected {sum(sizes)}"
            )
        bucket_ids = np.frombuffer(blob[: sizes[0]], "<i4").reshape(b, s)
        means_orig = np.frombuffer(blob[sizes[0] :], "<f4").reshape(b, dim)

        try:
            with open(meta_path) as f:
                inner_json = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise StorageIOError(
                f"cannot read metadata {meta_path}: {e}"
            ) from e

        old, is_primary, b_loc, b_pad = _round_robin_layout(b, ns)
        slot_ids_orig, max_dup = _derive_slot_ids(bucket_ids, params.count)
        if b_pad > b:
            max_dup += 1
        slot_ids_new = slot_ids_orig[old]
        n_rows = b * s

        def orig_rows(r0, r1):
            """Original-layout row indices backing NEW flat rows
            [r0, r1) (round-robin bucket relay)."""
            idx = np.arange(r0, r1)
            return old[idx // s] * s + idx % s

        if kind == "sq":
            inner_meta = SQMetadata.from_json(inner_json)
            row_size = inner_meta.actual_dim + 4
            cls._check_blob(data_path, n_rows, row_size)
            lane = inner_meta.actual_dim + (
                -inner_meta.actual_dim
            ) % sq_ops.LANE
            mm = np.memmap(data_path, np.uint8, "r").reshape(
                n_rows, row_size
            )

            def cb_codes(index):
                sl = index[0]
                r0 = sl.start or 0
                r1 = sl.stop if sl.stop is not None else b_pad * s
                rows = mm[orig_rows(r0, r1)]
                out = np.zeros((r1 - r0, lane), np.int8)
                out[:, : inner_meta.actual_dim] = rows[:, 4:].view(np.int8)
                return out

            def cb_voff(index):
                sl = index[0]
                r0 = sl.start or 0
                r1 = sl.stop if sl.stop is not None else b_pad * s
                rows = mm[orig_rows(r0, r1)]
                return (
                    np.ascontiguousarray(rows[:, :4])
                    .view(np.float32).reshape(-1)
                )

            codes = jax.make_array_from_callback(
                (b_pad * s, lane),
                NamedSharding(mesh, P(axis, None)), cb_codes,
            )
            voff = jax.make_array_from_callback(
                (b_pad * s,), NamedSharding(mesh, P(axis)), cb_voff
            )
            inner = (codes, voff)
        elif kind == "pq":
            inner_meta = PQMetadata.from_json(inner_json)
            m = len(inner_meta.vector_division)
            row_size = m if inner_meta.bits == 8 else (m + 1) // 2
            cls._check_blob(data_path, n_rows, row_size)
            mm = np.memmap(data_path, np.uint8, "r").reshape(
                n_rows, row_size
            )

            def cb_pq(index):
                sl = index[0]
                r0 = sl.start or 0
                r1 = sl.stop if sl.stop is not None else b_pad * s
                rows = mm[orig_rows(r0, r1)]
                if inner_meta.bits == 4:
                    un = np.empty((rows.shape[0], row_size * 2), np.uint8)
                    un[:, 0::2] = rows & 0x0F
                    un[:, 1::2] = rows >> 4
                    rows = un[:, :m]
                return np.ascontiguousarray(rows)

            codes = jax.make_array_from_callback(
                (b_pad * s, m), NamedSharding(mesh, P(axis, None)), cb_pq
            )
            inner = (codes,)
        else:  # bq
            inner_meta = BQMetadata.from_json(inner_json)
            # BQ metadata doesn't record the word tier; the blob size
            # does (u128 pads rows to 16 bytes, u8 to 1).
            store_type = "u128"
            row_size = bq_ops.storage_bytes(dim, store_type)
            if os.path.getsize(data_path) != n_rows * row_size:
                store_type = "u8"
                row_size = bq_ops.storage_bytes(dim, store_type)
            cls._check_blob(data_path, n_rows, row_size)
            wpad = _word_pad(row_size)
            mm = np.memmap(data_path, np.uint8, "r").reshape(
                n_rows, row_size
            )

            def cb_bq(index):
                sl = index[1]
                c0 = sl.start or 0
                c1 = sl.stop if sl.stop is not None else b_pad * s
                rows = np.ascontiguousarray(mm[orig_rows(c0, c1)])
                planes = bq_ops.rows_to_planes(rows)
                out = np.zeros((wpad, c1 - c0), np.uint32)
                out[: planes.shape[0]] = planes
                return out

            planes = jax.make_array_from_callback(
                (wpad, b_pad * s),
                NamedSharding(mesh, P(None, axis)), cb_bq,
            )
            inner = (planes,)

        means_dev = jax.device_put(
            means_orig[old], NamedSharding(mesh, P())
        )
        voff_inner = rowadd = None
        if meta.residual:
            flat_ids = bucket_ids[old].reshape(-1)
            pad_dev = jax.device_put(
                flat_ids < 0, NamedSharding(mesh, P(axis))
            )
            _, rowcoef = _residual_coeffs(
                params.distance_type, params.invert
            )
            if kind == "sq":
                rterm = _sq_rowterm_sharded(
                    inner[0], pad_dev, means_dev,
                    mesh=mesh, axis=axis, b_loc=b_loc, s=s, dim=dim,
                    alpha=inner_meta.alpha, offset=inner_meta.offset,
                    rowcoef=rowcoef,
                )
                voff_inner = inner[1]
                inner = (inner[0], rterm)
            elif kind == "pq":
                c_chunks = jnp.asarray(
                    pq_ops.centroids_to_chunks(
                        np.asarray(inner_meta.centroids),
                        inner_meta.vector_division,
                    )
                )
                rot = (
                    None if inner_meta.rotation is None
                    else jnp.asarray(inner_meta.rotation, jnp.float32)
                )
                rowadd = _pq_rowterm_sharded(
                    inner[0], pad_dev, means_dev, c_chunks, rot,
                    mesh=mesh, axis=axis, b_loc=b_loc, s=s,
                    division=tuple(inner_meta.vector_division),
                    rowcoef=rowcoef,
                )

        obj = cls.__new__(cls)
        obj._init_from_parts(
            mesh=mesh, axis=axis, metadata=meta, inner_meta=inner_meta,
            bucket_ids=bucket_ids, bucket_means=means_orig,
            means_new=means_dev, slot_ids_new=slot_ids_new,
            inner=inner, voff_inner=voff_inner, rowadd=rowadd,
            max_dup=max_dup,
            store_type=(store_type if kind == "bq" else "u128"),
        )
        return obj

    @staticmethod
    def _check_blob(data_path, n_rows: int, row_size: int) -> None:
        actual = os.path.getsize(data_path)
        if actual != n_rows * row_size:
            raise StorageIOError(
                f"file size {actual} does not match expected "
                f"{n_rows * row_size} ({n_rows} rows x {row_size} bytes)"
            )
