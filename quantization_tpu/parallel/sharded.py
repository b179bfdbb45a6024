"""Sharded corpus scoring over a device mesh — all three quantizers.

The reference's entire parallelism surface is intra-process rayon threading
(SURVEY.md §2); its scaling axis is corpus size, sharded by the caller. Here
sharding is first-class: the code matrix is sharded over the mesh's ``shard``
axis (the points axis), every device scores its shard with one quantized
matmul/popcount pass and computes a *local* top-k, and the only collective is
an ``all_gather`` of (k scores, k global indices) per shard followed by a
final merge — scores ride the device interconnect, never the host.

Construction paths:
  * wrap an already-encoded single-device quantizer (re-lays its arrays
    under a NamedSharding) — fine when the corpus fits one chip;
  * ``ShardedX.encode(data, params, mesh=...)`` — streaming sharded-native
    ingestion: each host batch is quantized and committed straight into
    per-shard device buffers, so the corpus codes NEVER materialize on one
    device (the counterpart of the reference's injectable storage seam,
    encoded_storage.rs:7-25);
  * ``ShardedX.load(...)`` — reads the reference two-file format shard by
    shard (each shard's slice goes straight to its device).

``save`` writes the same reference-compatible blob shard by shard. Both
require a fully-addressable mesh (single-controller; multi-host writes per
process only its addressable shards).

For two-stage retrieval every sharded class exposes ``top_k_device`` (results
stay on device) and ``score_candidates`` (candidate ids replicated; each
shard rescoring the ids it owns, merged with one ``psum``), so a
``TwoStageIndex`` can run entirely on sharded stages.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.types import (
    ArgumentsError,
    DistanceType,
    StorageIOError,
    VectorParameters,
    check_stop,
)
from ..models.bq import BinaryQuantizer, BQMetadata, EncodedQueryBin
from ..models.pq import EncodedQueryPQ, PQMetadata, ProductQuantizer
from ..models.sq import (
    EncodedQueryU8,
    ScalarQuantizerU8,
    SQMetadata,
    calibrate_sq,
)
from ..ops import bq as bq_ops
from ..ops import pq as pq_ops
from ..ops import sq as sq_ops
from ..utils.device_store import DeviceAppender

NEG_INF = float("-inf")  # Python float: no backend init at import (ops/topk.py)


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("shard",),
    shape: Optional[Sequence[int]] = None,
) -> Mesh:
    """Build a mesh over the first ``n_devices`` devices.

    Default is a 1-D ``('shard',)`` mesh over all devices. Pass
    ``axis_names=('shard', 'qdp')`` with a ``shape`` to add query data
    parallelism.
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ArgumentsError(
            f"requested {n_devices} devices but only {len(devices)} available"
        )
    devices = np.asarray(devices[:n_devices])
    if shape is None:
        shape = (n_devices,) if len(axis_names) == 1 else None
    if shape is None:
        raise ArgumentsError("shape required for multi-axis meshes")
    return Mesh(devices.reshape(tuple(shape)), tuple(axis_names))


def gathered_topk_merge(
    s: jax.Array,  # [Q, kk] this shard's local top scores
    gi: jax.Array,  # [Q, kk] matching GLOBAL ids
    axis: str,
    k: int,
) -> Tuple[jax.Array, jax.Array]:
    """Cross-shard tail: all-gather k rows per shard, exact merge. The only
    collective of a sharded search — [shards, Q, k] scores ride the device
    interconnect, never the host."""
    s_all = jax.lax.all_gather(s, axis, axis=1, tiled=True)
    gi_all = jax.lax.all_gather(gi, axis, axis=1, tiled=True)
    s_out, pos = jax.lax.top_k(s_all, min(k, s_all.shape[1]))
    gi_out = jnp.take_along_axis(gi_all, pos, axis=1)
    if s_out.shape[1] < k:
        pad = k - s_out.shape[1]
        s_out = jnp.pad(s_out, ((0, 0), (0, pad)), constant_values=NEG_INF)
        gi_out = jnp.pad(gi_out, ((0, 0), (0, pad)), constant_values=-1)
    return s_out, gi_out


def local_topk_merge(
    scores: jax.Array,  # [Q, n_local] this shard's scores
    axis: str,
    k: int,
    count: int,
) -> Tuple[jax.Array, jax.Array]:
    """Shared tail of every sharded scorer: mask shard padding, local top-k,
    all-gather k rows per shard, merge. Replaces the reference caller's
    point loop + heap (ann_benchmark_data.rs:151-166). Selection is exact
    for every ``method`` (ops/topk.py)."""
    n_local = scores.shape[1]
    shard_idx = jax.lax.axis_index(axis)
    gidx = jax.lax.broadcasted_iota(jnp.int32, scores.shape, 1) + (
        shard_idx * n_local
    )
    scores = jnp.where(gidx < count, scores, NEG_INF)
    kk = min(k, n_local)
    s, i = jax.lax.top_k(scores, kk)
    gi = jnp.take_along_axis(gidx, i, axis=1)
    return gathered_topk_merge(s, gi, axis, k)


def _pad_rows(arr: np.ndarray, target: int, fill=0) -> np.ndarray:
    if arr.shape[0] == target:
        return arr
    pad = [(0, target - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad, constant_values=fill)


def _owned_rows_psum(arr_shard, local_ids, owned, axis, rows_axis):
    """Materialize arr[ids] replicated on every shard: the owning shard
    contributes each requested row (zeros elsewhere), one psum completes
    the distributed gather. ids must be pre-clipped to [0, count) so each
    is owned by exactly one shard. Used by the sharded score_internal
    implementations (the rows are [P, D]-small, so the all-reduce is cheap
    next to any scan)."""
    n_local = arr_shard.shape[rows_axis]
    safe = jnp.clip(local_ids, 0, n_local - 1)
    rows = jnp.take(arr_shard, safe, axis=rows_axis)
    shape = [1, 1]
    shape[rows_axis] = local_ids.shape[0]
    mask = owned.reshape(shape)
    rows = jnp.where(mask, rows, jnp.zeros_like(rows))
    return jax.lax.psum(rows, axis)


def _owned_scores_psum(scores, owned, axis):
    """Merge per-shard owned-candidate scores across shards. A candidate id
    owned by NO shard (negative / >= count padding ids, which coarse approx
    stages can emit) scores NEG_INF, not 0.0 — with ``invert`` metrics all
    real scores are negative, so a silent 0.0 would rank garbage FIRST in
    the downstream top-k."""
    summed = jax.lax.psum(jnp.where(owned, scores, 0.0), axis)
    any_owned = jax.lax.psum(owned.astype(jnp.float32), axis) > 0
    return jnp.where(any_owned, summed, NEG_INF)


class _ShardedBase:
    """Common state. Two construction paths: wrap a single-device quantizer
    (``quantizer`` set) or build from sharded parts (``metadata`` set)."""

    def __init__(self, quantizer, mesh: Optional[Mesh], axis: str,
                 metadata=None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.axis = axis
        self.quantizer = quantizer
        self.metadata = metadata if metadata is not None else quantizer.metadata
        self.params = self.metadata.vector_parameters
        self.count = self.params.count
        self.n_shards = self.mesh.shape[axis]

    def encode_query(self, queries):
        if self.quantizer is not None:
            return self.quantizer.encode_query(queries)
        return self._encode_query_from_meta(queries)

    def top_k(self, equery, k: int, method: str = "exact",
              recall_target=None):
        s, i = self.top_k_device(
            equery, k, method=method, recall_target=recall_target
        )
        return np.asarray(s), np.asarray(i)

    def score_internal(self, i: int, j: int) -> float:
        """Scalar parity shim over score_internal_batch (the trait method
        of encoded_vectors.rs:34)."""
        out = np.asarray(
            self.score_internal_batch(np.asarray([i]), np.asarray([j]))
        )
        return float(out.reshape(-1)[0])

    def _shard_dim(self, n: int, tile: int = 1) -> int:
        """Pad the corpus axis so every shard is a multiple of ``tile``
        (the layout's row alignment; the padding is masked out by
        ``count`` in local_topk_merge)."""
        step = self.n_shards * tile
        return max(n + (-n) % step, step)

    @staticmethod
    def _shard_dim_for(mesh: Mesh, axis: str, n: int, tile: int) -> int:
        step = mesh.shape[axis] * tile
        return max(n + (-n) % step, step)

    def _write_blob_sharded(self, path, arr, axis_dim: int, row_writer,
                            row_size: int):
        """Write the reference blob shard by shard: ``row_writer(rows_np,
        start_row)`` converts one shard's device slice to file rows; rows
        past ``count`` are dropped. ``axis_dim`` is the array axis that
        carries the corpus."""
        n = self.count
        with open(path, "wb") as f:
            f.truncate(n * row_size)
            seen = set()
            for shard in arr.addressable_shards:
                sl = shard.index[axis_dim]
                r0 = sl.start or 0
                if r0 in seen or r0 >= n:
                    continue  # replicated copy on another mesh axis / padding
                seen.add(r0)
                data_np = np.asarray(shard.data)
                rows = row_writer(data_np)
                valid = min(rows.shape[0], n - r0)
                f.seek(r0 * row_size)
                f.write(rows[:valid].tobytes())


# --------------------------------------------------------------------- SQ


class ShardedScalarQuantizer(_ShardedBase):
    """SQ corpus sharded over the mesh: codes int8[N/s, D] per device."""

    def __init__(
        self,
        quantizer: ScalarQuantizerU8,
        mesh: Optional[Mesh] = None,
        axis: str = "shard",
    ):
        super().__init__(quantizer, mesh, axis)
        n_pad = self._shard_dim(self.count, sq_ops.ROW_ALIGN)
        codes = _pad_rows(np.asarray(quantizer.codes)[: self.count], n_pad)
        voff = _pad_rows(np.asarray(quantizer.voffsets)[: self.count], n_pad)
        self.codes = jax.device_put(
            codes, NamedSharding(self.mesh, P(axis, None))
        )
        self.voffsets = jax.device_put(voff, NamedSharding(self.mesh, P(axis)))
        self._mult_dev = jnp.float32(self.metadata.multiplier)

    @classmethod
    def _from_parts(
        cls, codes, voffsets, metadata: SQMetadata, mesh: Mesh, axis: str
    ) -> "ShardedScalarQuantizer":
        obj = cls.__new__(cls)
        _ShardedBase.__init__(obj, None, mesh, axis, metadata=metadata)
        obj.codes = codes
        obj.voffsets = voffsets
        obj._mult_dev = jnp.float32(metadata.multiplier)
        return obj

    @classmethod
    def encode(
        cls,
        data,
        params: VectorParameters,
        mesh: Optional[Mesh] = None,
        axis: str = "shard",
        quantile: Optional[float] = None,
        stop_condition=None,
        batch_size: int = 65536,
        seed: int = 0,
    ) -> "ShardedScalarQuantizer":
        """Sharded-native streaming encode: calibrate over the batch stream,
        then quantize batch-by-batch straight into the sharded code buffer —
        the corpus never materializes on a single device. Cancellation is
        checked between batches (≙ stop_condition,
        encoded_vectors_u8.rs:74)."""
        from ..core.interface import iter_batches

        mesh = mesh if mesh is not None else make_mesh()
        actual = sq_ops.actual_dim(params.dim)
        lane = actual + (-actual) % sq_ops.LANE

        def batches():
            return iter_batches(data, batch_size)

        alpha, offset = calibrate_sq(
            batches, params, quantile, stop_condition, seed
        ) if params.count else (0.0, 0.0)

        npad = cls._shard_dim_for(mesh, axis, params.count, sq_ops.ROW_ALIGN)
        codes_app = DeviceAppender(
            (npad, lane), jnp.int8,
            sharding=NamedSharding(mesh, P(axis, None)),
        )
        voff_app = DeviceAppender(
            (npad,), jnp.float32, sharding=NamedSharding(mesh, P(axis))
        )
        total = 0
        for batch in batches():
            check_stop(stop_condition)
            if batch.shape[1] != params.dim:
                raise ArgumentsError(
                    f"Vector length {batch.shape[1]} does not match vector "
                    f"parameters dim {params.dim}"
                )
            if total + batch.shape[0] > params.count:
                raise ArgumentsError(
                    f"Vector count exceeds vector parameters count "
                    f"{params.count}"
                )
            cb, vb = sq_ops.quantize_batch(
                jnp.asarray(batch),
                alpha=alpha,
                offset=offset,
                distance_type=params.distance_type,
                invert=params.invert,
                dpad=actual,
                lane=lane,
            )
            codes_app.append(cb)
            voff_app.append(vb)
            total += batch.shape[0]
        if total != params.count:
            raise ArgumentsError(
                f"Vector count {total} does not match vector parameters "
                f"count {params.count}"
            )
        multiplier = sq_ops.multiplier_for(
            params.distance_type, params.invert, alpha
        )
        meta = SQMetadata(actual, alpha, offset, multiplier, params)
        return cls._from_parts(
            codes_app.finish(), voff_app.finish(), meta, mesh, axis
        )

    def _encode_query_from_meta(self, queries) -> EncodedQueryU8:
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != self.params.dim:
            raise ArgumentsError(
                f"query dim {q.shape[1]} != corpus dim {self.params.dim}"
            )
        m = self.metadata
        codes, qoff = sq_ops.encode_query_batch(
            jnp.asarray(q),
            alpha=m.alpha,
            offset=m.offset,
            distance_type=self.params.distance_type,
            invert=self.params.invert,
            dpad=m.actual_dim,
            lane=self.codes.shape[1],
        )
        return EncodedQueryU8(codes, qoff)

    def top_k_device(
        self, equery: EncodedQueryU8, k: int, method: str = "exact",
        recall_target: Optional[float] = None,
    ) -> Tuple[jax.Array, jax.Array]:
        return _sq_sharded_topk(
            equery.codes,
            equery.offsets,
            self.codes,
            self.voffsets,
            self._mult_dev,
            mesh=self.mesh,
            axis=self.axis,
            k=k,
            count=self.count,
            distance_type=self.params.distance_type,
        )

    def score_candidates(self, equery: EncodedQueryU8, cand) -> jax.Array:
        """[Q, R] scores for global candidate ids: each shard rescans the
        ids it owns; one psum merges (ids < 0 or >= count score 0)."""
        return _sq_sharded_score_candidates(
            equery.codes,
            equery.offsets,
            self.codes,
            self.voffsets,
            self._mult_dev,
            jnp.asarray(cand, jnp.int32),
            mesh=self.mesh,
            axis=self.axis,
            count=self.count,
            distance_type=self.params.distance_type,
        )

    def score_internal_batch(self, ids_a, ids_b) -> jax.Array:
        """[P] stored-vs-stored scores (encoded_vectors.rs:34 /
        encoded_vectors_u8.rs:386-453) with the corpus sharded: each pair's
        rows are gathered from their owning shards with one psum, then
        scored replicated."""
        m = self.metadata
        diff = m.actual_dim * m.offset * m.offset
        diff = -diff if self.params.invert else diff
        hi = max(self.count - 1, 0)
        return _sq_sharded_score_internal(
            jnp.clip(jnp.asarray(ids_a, jnp.int32), 0, hi),
            jnp.clip(jnp.asarray(ids_b, jnp.int32), 0, hi),
            self.codes,
            self.voffsets,
            self._mult_dev,
            jnp.float32(diff),
            mesh=self.mesh,
            axis=self.axis,
            distance_type=self.params.distance_type,
        )

    # ----------------------------------------------------------- checkpoint
    def save(self, data_path, meta_path) -> None:
        """Reference two-file format (encoded_vectors_u8.rs:263-271), blob
        written shard by shard — no single-device gather."""
        import json
        import os

        meta_dir = os.path.dirname(os.fspath(meta_path))
        if meta_dir:
            os.makedirs(meta_dir, exist_ok=True)
        with open(meta_path, "w") as f:
            json.dump(self.metadata.to_json(), f)
        m = self.metadata
        row_size = m.actual_dim + 4
        voffs = {
            (s.index[0].start or 0): np.asarray(s.data)
            for s in self.voffsets.addressable_shards
        }

        def rows_of(codes_np, r0=None):
            n_rows = codes_np.shape[0]
            rows = np.zeros((n_rows, row_size), np.uint8)
            rows[:, 4:] = codes_np[:, : m.actual_dim].view(np.uint8)
            return rows

        n = self.count
        with open(data_path, "wb") as f:
            f.truncate(n * row_size)
            seen = set()
            for shard in self.codes.addressable_shards:
                r0 = shard.index[0].start or 0
                if r0 in seen or r0 >= n:
                    continue
                seen.add(r0)
                codes_np = np.asarray(shard.data)
                rows = rows_of(codes_np)
                voff = voffs[r0].astype(np.float32)
                rows[:, :4] = voff.view(np.uint8).reshape(-1, 4)
                valid = min(rows.shape[0], n - r0)
                f.seek(r0 * row_size)
                f.write(rows[:valid].tobytes())

    @classmethod
    def load(
        cls,
        data_path,
        meta_path,
        params: VectorParameters,
        mesh: Optional[Mesh] = None,
        axis: str = "shard",
    ) -> "ShardedScalarQuantizer":
        """Load the reference two-file format shard by shard: each device
        reads only its slice of the blob (via a memory map)."""
        import json
        import os

        mesh = mesh if mesh is not None else make_mesh()
        try:
            with open(meta_path) as f:
                meta = SQMetadata.from_json(json.load(f))
        except (OSError, json.JSONDecodeError, KeyError) as e:
            raise StorageIOError(f"cannot read metadata {meta_path}: {e}") from e
        row_size = meta.actual_dim + 4
        n = params.count
        expected = n * row_size
        actual_size = os.path.getsize(data_path)
        if actual_size != expected:
            raise StorageIOError(
                f"file size {actual_size} does not match expected "
                f"{expected} ({n} rows x {row_size} bytes)"
            )
        lane = meta.actual_dim + (-meta.actual_dim) % sq_ops.LANE
        npad = cls._shard_dim_for(mesh, axis, n, sq_ops.ROW_ALIGN)
        mm = (
            np.memmap(data_path, np.uint8, "r").reshape(n, row_size)
            if n
            else None
        )

        def cb_codes(index):
            sl = index[0]
            r0, r1 = sl.start or 0, sl.stop if sl.stop is not None else npad
            out = np.zeros((r1 - r0, lane), np.int8)
            v = max(0, min(r1, n) - r0)
            if v:
                out[:v, : meta.actual_dim] = mm[r0 : r0 + v, 4:].view(np.int8)
            return out

        def cb_voff(index):
            sl = index[0]
            r0, r1 = sl.start or 0, sl.stop if sl.stop is not None else npad
            out = np.zeros((r1 - r0,), np.float32)
            v = max(0, min(r1, n) - r0)
            if v:
                out[:v] = (
                    mm[r0 : r0 + v, :4].copy().view(np.float32).reshape(v)
                )
            return out

        codes = jax.make_array_from_callback(
            (npad, lane), NamedSharding(mesh, P(axis, None)), cb_codes
        )
        voff = jax.make_array_from_callback(
            (npad,), NamedSharding(mesh, P(axis)), cb_voff
        )
        return cls._from_parts(codes, voff, meta, mesh, axis)


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "axis", "k", "count", "distance_type",
    ),
)
def _sq_sharded_topk(
    qcodes, qoff, codes, voff, multiplier, *, mesh, axis, k, count,
    distance_type,
):
    def local(qc, qo, c, vo, mult):
        if distance_type == DistanceType.L1:
            raw = sq_ops.int_l1(qc, c)
        else:
            raw = sq_ops.int_dot(qc, c)
        scores = mult * raw.astype(jnp.float32) + qo[:, None] + vo[None, :]
        return local_topk_merge(
            scores, axis, k, count,
        )

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, None), P(None), P(axis, None), P(axis), P()),
        out_specs=(P(None, None), P(None, None)),
        check_vma=False,
    )
    return fn(qcodes, qoff, codes, voff, multiplier)


@partial(
    jax.jit,
    static_argnames=("mesh", "axis", "count", "distance_type"),
)
def _sq_sharded_score_candidates(
    qcodes, qoff, codes, voff, multiplier, cand, *, mesh, axis, count,
    distance_type,
):
    def local(qc, qo, c, vo, mult, cd):
        n_local = c.shape[0]
        shard_idx = jax.lax.axis_index(axis)
        local_ids = cd - shard_idx * n_local
        owned = (local_ids >= 0) & (local_ids < n_local) & (cd < count) & (
            cd >= 0
        )
        safe = jnp.clip(local_ids, 0, n_local - 1)
        flat = safe.reshape(-1)
        g = jnp.take(c, flat, axis=0).reshape(cd.shape + (c.shape[1],))
        goff = jnp.take(vo, flat).reshape(cd.shape)
        scores = sq_ops._score_gathered(
            qc, qo, g, goff, mult, distance_type=distance_type
        )
        return _owned_scores_psum(scores, owned, axis)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(None, None), P(None), P(axis, None), P(axis), P(),
            P(None, None),
        ),
        out_specs=P(None, None),
        check_vma=False,
    )
    return fn(qcodes, qoff, codes, voff, multiplier, cand)


# --------------------------------------------------------------------- BQ


@partial(
    jax.jit, static_argnames=("mesh", "axis", "distance_type")
)
def _sq_sharded_score_internal(
    ia, ib, codes, voff, mult, diff, *, mesh, axis, distance_type
):
    def local(ia_r, ib_r, codes_shard, voff_shard, mlt, dff):
        n_local = codes_shard.shape[0]
        shard_idx = jax.lax.axis_index(axis)

        def full_rows(ids):
            lid = ids - shard_idx * n_local
            owned = (lid >= 0) & (lid < n_local)
            # int8 codes ride the psum as f32 (each element has exactly
            # one non-zero contributor, so the sum is exact).
            rows = _owned_rows_psum(
                codes_shard.astype(jnp.float32), lid, owned, axis, 0
            )
            safe = jnp.clip(lid, 0, n_local - 1)
            v = jnp.where(owned, jnp.take(voff_shard, safe), 0.0)
            return rows, jax.lax.psum(v, axis)

        ca, va = full_rows(ia_r)
        cb, vb = full_rows(ib_r)
        return sq_ops.score_internal_batch_xla(
            ca, va, cb, vb, mlt, dff, distance_type=distance_type
        )

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None), P(None), P(axis, None), P(axis), P(), P()),
        out_specs=P(None),
        check_vma=False,
    )
    return fn(ia, ib, codes, voff, mult, diff)


@partial(
    jax.jit,
    static_argnames=("mesh", "axis", "distance_type", "invert", "dim"),
)
def _bq_sharded_score_internal(
    ia, ib, planes, *, mesh, axis, distance_type, invert, dim
):
    def local(ia_r, ib_r, pl_shard):
        n_local = pl_shard.shape[1]
        shard_idx = jax.lax.axis_index(axis)

        def cols(ids):
            lid = ids - shard_idx * n_local
            owned = (lid >= 0) & (lid < n_local)
            # uint32 planes psum exactly: one non-zero contributor per
            # element (each id owned by exactly one shard).
            return _owned_rows_psum(pl_shard, lid, owned, axis, 1)  # [W, P]

        xor = jnp.sum(
            jax.lax.population_count(
                jnp.bitwise_xor(cols(ia_r), cols(ib_r))
            ).astype(jnp.int32),
            axis=0,
        )
        return bq_ops.metric_from_xor(
            xor, distance_type=distance_type, invert=invert, dim=dim
        )

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None), P(None), P(None, axis)),
        out_specs=P(None),
        check_vma=False,
    )
    return fn(ia, ib, planes)


def _word_pad(row_bytes: int) -> int:
    """Plane words per row, padded to the layout's word alignment."""
    w = (row_bytes + 3) // 4
    return max(w + (-w) % bq_ops.WORD_ALIGN, bq_ops.WORD_ALIGN)


class ShardedBinaryQuantizer(_ShardedBase):
    """BQ bit-planes sharded over the corpus axis: uint32[W, N/s] per
    device."""

    def __init__(
        self,
        quantizer: BinaryQuantizer,
        mesh: Optional[Mesh] = None,
        axis: str = "shard",
    ):
        super().__init__(quantizer, mesh, axis)
        self.store_type = quantizer.store_type
        n_pad = self._shard_dim(self.count, bq_ops.SHARD_ROW_ALIGN)
        planes = np.asarray(quantizer.planes)[:, : self.count]
        if planes.shape[1] < n_pad:
            planes = np.pad(planes, ((0, 0), (0, n_pad - planes.shape[1])))
        self.planes = jax.device_put(
            planes, NamedSharding(self.mesh, P(None, axis))
        )

    @classmethod
    def _from_parts(
        cls, planes, metadata: BQMetadata, mesh: Mesh, axis: str,
        store_type: str,
    ) -> "ShardedBinaryQuantizer":
        obj = cls.__new__(cls)
        _ShardedBase.__init__(obj, None, mesh, axis, metadata=metadata)
        obj.planes = planes
        obj.store_type = store_type
        return obj

    @classmethod
    def encode(
        cls,
        data,
        params: VectorParameters,
        mesh: Optional[Mesh] = None,
        axis: str = "shard",
        stop_condition=None,
        batch_size: int = 65536,
        store_type: str = "u128",
    ) -> "ShardedBinaryQuantizer":
        """Streaming sharded-native sign-bit packing
        (encoded_vectors_binary.rs:165-191 semantics, per-shard buffers)."""
        from ..core.interface import iter_batches

        mesh = mesh if mesh is not None else make_mesh()
        row_bytes = bq_ops.storage_bytes(params.dim, store_type)
        wpad = _word_pad(row_bytes)
        npad = cls._shard_dim_for(
            mesh, axis, params.count, bq_ops.SHARD_ROW_ALIGN
        )
        app = DeviceAppender(
            (wpad, npad), jnp.uint32,
            sharding=NamedSharding(mesh, P(None, axis)), axis=1,
        )
        total = 0
        for batch in iter_batches(data, batch_size):
            check_stop(stop_condition)
            if batch.shape[1] != params.dim:
                raise ArgumentsError(
                    f"Vector length {batch.shape[1]} does not match vector "
                    f"parameters dim {params.dim}"
                )
            if total + batch.shape[0] > params.count:
                raise ArgumentsError(
                    f"Vector count exceeds vector parameters count "
                    f"{params.count}"
                )
            rows = bq_ops.pack_rows(batch, row_bytes)
            planes = bq_ops.rows_to_planes(rows)  # [w, B]
            if planes.shape[0] < wpad:
                planes = np.pad(
                    planes, ((0, wpad - planes.shape[0]), (0, 0))
                )
            app.append(jnp.asarray(planes))
            total += batch.shape[0]
        if total != params.count:
            raise ArgumentsError(
                f"Vector count {total} does not match vector parameters "
                f"count {params.count}"
            )
        return cls._from_parts(
            app.finish(), BQMetadata(params), mesh, axis, store_type
        )

    def _encode_query_from_meta(self, queries) -> EncodedQueryBin:
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != self.params.dim:
            raise ArgumentsError(
                f"query dim {q.shape[1]} != corpus dim {self.params.dim}"
            )
        row_bytes = bq_ops.storage_bytes(self.params.dim, self.store_type)
        rows = bq_ops.pack_rows(q, row_bytes)
        pad = (-row_bytes) % 4
        if pad:
            rows = np.pad(rows, ((0, 0), (0, pad)))
        words = rows.reshape(rows.shape[0], -1, 4).view(np.uint32)
        words = words.reshape(rows.shape[0], -1)
        w8 = self.planes.shape[0]
        if words.shape[1] < w8:
            words = np.pad(words, ((0, 0), (0, w8 - words.shape[1])))
        return EncodedQueryBin(jnp.asarray(words))

    def top_k_device(
        self, equery: EncodedQueryBin, k: int, method: str = "exact",
        recall_target: Optional[float] = None,
    ) -> Tuple[jax.Array, jax.Array]:
        p = self.params
        return _bq_sharded_topk(
            equery.planes,
            self.planes,
            mesh=self.mesh,
            axis=self.axis,
            k=k,
            count=self.count,
            distance_type=p.distance_type,
            invert=p.invert,
            dim=p.dim,
        )

    def score_internal_batch(self, ids_a, ids_b) -> jax.Array:
        """[P] Hamming-metric scores between stored rows, gathered from
        their owning shards with one psum (encoded_vectors_binary.rs:302)."""
        hi = max(self.count - 1, 0)
        return _bq_sharded_score_internal(
            jnp.clip(jnp.asarray(ids_a, jnp.int32), 0, hi),
            jnp.clip(jnp.asarray(ids_b, jnp.int32), 0, hi),
            self.planes,
            mesh=self.mesh,
            axis=self.axis,
            distance_type=self.params.distance_type,
            invert=self.params.invert,
            dim=self.params.dim,
        )

    def score_candidates(self, equery: EncodedQueryBin, cand) -> jax.Array:
        p = self.params
        return _bq_sharded_score_candidates(
            equery.planes,
            self.planes,
            jnp.asarray(cand, jnp.int32),
            mesh=self.mesh,
            axis=self.axis,
            count=self.count,
            distance_type=p.distance_type,
            invert=p.invert,
            dim=p.dim,
        )

    # ----------------------------------------------------------- checkpoint
    def save(self, data_path, meta_path) -> None:
        import json
        import os

        meta_dir = os.path.dirname(os.fspath(meta_path))
        if meta_dir:
            os.makedirs(meta_dir, exist_ok=True)
        with open(meta_path, "w") as f:
            json.dump(self.metadata.to_json(), f)
        row_bytes = bq_ops.storage_bytes(self.params.dim, self.store_type)
        self._write_blob_sharded(
            data_path,
            self.planes,
            axis_dim=1,
            row_writer=lambda planes_np: bq_ops.planes_to_rows(
                planes_np, row_bytes
            ),
            row_size=row_bytes,
        )

    @classmethod
    def load(
        cls,
        data_path,
        meta_path,
        params: VectorParameters,
        mesh: Optional[Mesh] = None,
        axis: str = "shard",
        store_type: str = "u128",
    ) -> "ShardedBinaryQuantizer":
        import json
        import os

        mesh = mesh if mesh is not None else make_mesh()
        try:
            with open(meta_path) as f:
                meta = BQMetadata.from_json(json.load(f))
        except (OSError, json.JSONDecodeError, KeyError) as e:
            raise StorageIOError(f"cannot read metadata {meta_path}: {e}") from e
        row_bytes = bq_ops.storage_bytes(params.dim, store_type)
        n = params.count
        expected = n * row_bytes
        actual_size = os.path.getsize(data_path)
        if actual_size != expected:
            raise StorageIOError(
                f"file size {actual_size} does not match expected {expected}"
            )
        wpad = _word_pad(row_bytes)
        npad = cls._shard_dim_for(mesh, axis, n, bq_ops.SHARD_ROW_ALIGN)
        mm = (
            np.memmap(data_path, np.uint8, "r").reshape(n, row_bytes)
            if n
            else None
        )

        def cb(index):
            sl = index[1]
            c0, c1 = sl.start or 0, sl.stop if sl.stop is not None else npad
            out = np.zeros((wpad, c1 - c0), np.uint32)
            v = max(0, min(c1, n) - c0)
            if v:
                planes = bq_ops.rows_to_planes(
                    np.ascontiguousarray(mm[c0 : c0 + v])
                )
                out[: planes.shape[0], :v] = planes
            return out

        planes = jax.make_array_from_callback(
            (wpad, npad), NamedSharding(mesh, P(None, axis)), cb
        )
        return cls._from_parts(planes, meta, mesh, axis, store_type)


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "axis", "k", "count", "distance_type", "invert", "dim",
    ),
)
def _bq_sharded_topk(
    qplanes, planes, *, mesh, axis, k, count, distance_type, invert, dim,
):
    def local(qp, pl_shard):
        scores = bq_ops.score_batch_xla(
            qp, pl_shard, distance_type=distance_type, invert=invert, dim=dim
        )
        return local_topk_merge(
            scores, axis, k, count,
        )

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, None), P(None, axis)),
        out_specs=(P(None, None), P(None, None)),
        check_vma=False,
    )
    return fn(qplanes, planes)


@partial(
    jax.jit,
    static_argnames=("mesh", "axis", "count", "distance_type", "invert", "dim"),
)
def _bq_sharded_score_candidates(
    qplanes, planes, cand, *, mesh, axis, count, distance_type, invert, dim
):
    def local(qp, pl_shard, cd):
        n_local = pl_shard.shape[1]
        shard_idx = jax.lax.axis_index(axis)
        local_ids = cd - shard_idx * n_local
        owned = (local_ids >= 0) & (local_ids < n_local) & (cd < count) & (
            cd >= 0
        )
        safe = jnp.clip(local_ids, 0, n_local - 1)
        scores = bq_ops.score_candidates_xla(
            qp, pl_shard, safe,
            distance_type=distance_type, invert=invert, dim=dim,
        )
        return _owned_scores_psum(scores, owned, axis)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, None), P(None, axis), P(None, None)),
        out_specs=P(None, None),
        check_vma=False,
    )
    return fn(qplanes, planes, cand)


# --------------------------------------------------------------------- PQ


class ShardedProductQuantizer(_ShardedBase):
    """PQ codes sharded over the corpus axis: u8[m, N/s] per device; the LUT
    is replicated (it is per-query, tiny)."""

    def __init__(
        self,
        quantizer: ProductQuantizer,
        mesh: Optional[Mesh] = None,
        axis: str = "shard",
    ):
        super().__init__(quantizer, mesh, axis)
        n_pad = self._shard_dim(self.count, pq_ops.ROW_ALIGN)
        self.num_chunks = quantizer.num_chunks
        # Transposed [Mpad, Npad] layout sharded on the corpus axis.
        codes_t = np.asarray(quantizer.codes_t)[:, : self.count]
        if codes_t.shape[1] < n_pad:
            codes_t = np.pad(codes_t, ((0, 0), (0, n_pad - codes_t.shape[1])))
        self.codes_t = jax.device_put(
            codes_t, NamedSharding(self.mesh, P(None, axis))
        )
        self._c_chunks = quantizer._c_chunks
        self._rot = quantizer._rot

    @classmethod
    def _from_parts(
        cls, codes_t, metadata: PQMetadata, mesh: Mesh, axis: str
    ) -> "ShardedProductQuantizer":
        obj = cls.__new__(cls)
        _ShardedBase.__init__(obj, None, mesh, axis, metadata=metadata)
        obj.codes_t = codes_t
        obj.num_chunks = len(metadata.vector_division)
        obj._c_chunks = jnp.asarray(
            pq_ops.centroids_to_chunks(
                np.asarray(metadata.centroids), metadata.vector_division
            )
        )
        obj._rot = (
            None
            if metadata.rotation is None
            else jnp.asarray(metadata.rotation, jnp.float32)
        )
        return obj

    @classmethod
    def encode(
        cls,
        data,
        params: VectorParameters,
        chunk_size: int,
        mesh: Optional[Mesh] = None,
        axis: str = "shard",
        stop_condition=None,
        batch_size: int = 16384,
        seed: int = 0,
        bits: int = 8,
        rotation=None,
    ) -> "ShardedProductQuantizer":
        """Streaming sharded-native PQ: k-means on a sample (replicated —
        centroids are tiny), then nearest-centroid codes committed batch by
        batch into the sharded transposed code buffer. ``rotation`` enables
        OPQ exactly as on the single-device class (models/pq.py) — the
        rotation is replicated (it is [dim, dim], tiny next to codes)."""
        from ..core.interface import iter_batches

        if bits not in (4, 8):
            raise ArgumentsError(f"bits must be 4 or 8, got {bits}")
        mesh = mesh if mesh is not None else make_mesh()
        division = pq_ops.get_vector_division(params.dim, chunk_size)
        k = pq_ops.CENTROIDS_COUNT if bits == 8 else pq_ops.CENTROIDS_COUNT4

        def batches():
            return iter_batches(data, batch_size)

        centroids, rot = ProductQuantizer._find_centroids(
            batches, division, params, stop_condition, seed, k,
            rotation=rotation,
        )
        rot_j = None if rot is None else jnp.asarray(rot)
        c_chunks = jnp.asarray(pq_ops.centroids_to_chunks(centroids, division))

        m = len(division)
        mpad = max(m + (-m) % pq_ops.CHUNK_ALIGN, pq_ops.CHUNK_ALIGN)
        npad = cls._shard_dim_for(mesh, axis, params.count, pq_ops.ROW_ALIGN)
        app = DeviceAppender(
            (mpad, npad), jnp.uint8,
            sharding=NamedSharding(mesh, P(None, axis)), axis=1,
        )
        total = 0
        for batch in batches():
            check_stop(stop_condition)
            if batch.shape[1] != params.dim:
                raise ArgumentsError(
                    f"Vector length {batch.shape[1]} does not match vector "
                    f"parameters dim {params.dim}"
                )
            if total + batch.shape[0] > params.count:
                raise ArgumentsError(
                    f"Vector count exceeds vector parameters count "
                    f"{params.count}"
                )
            if rot_j is not None:
                x_chunks = pq_ops.chunk_rows_device(
                    jnp.asarray(batch, jnp.float32) @ rot_j, division
                )
            else:
                x_chunks = jnp.asarray(pq_ops.chunk_tensor(batch, division))
            codes = pq_ops.encode_batch(x_chunks, c_chunks)  # [B, m] u8
            ct = jnp.pad(codes.T, ((0, mpad - m), (0, 0)))
            app.append(ct)
            total += batch.shape[0]
        if total != params.count:
            raise ArgumentsError(
                f"Vector count {total} does not match vector parameters "
                f"count {params.count}"
            )
        meta = PQMetadata(centroids, division, params, bits=bits, rotation=rot)
        return cls._from_parts(app.finish(), meta, mesh, axis)

    def _encode_query_from_meta(self, queries) -> EncodedQueryPQ:
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != self.params.dim:
            raise ArgumentsError(
                f"query dim {q.shape[1]} != corpus dim {self.params.dim}"
            )
        if getattr(self, "_rot", None) is not None:
            # HIGHEST: query-side rotation at data scale (models/pq.py).
            q_chunks = pq_ops.chunk_rows_device(
                jnp.matmul(
                    jnp.asarray(q, jnp.float32), self._rot,
                    precision=jax.lax.Precision.HIGHEST,
                ),
                self.metadata.vector_division,
            )
        else:
            q_chunks = jnp.asarray(
                pq_ops.chunk_tensor(q, self.metadata.vector_division)
            )
        lut = pq_ops.build_lut(
            q_chunks,
            self._c_chunks,
            distance_type=self.params.distance_type,
            invert=self.params.invert,
        )
        return EncodedQueryPQ(lut)

    def top_k_device(
        self, equery: EncodedQueryPQ, k: int, method: str = "exact",
        recall_target: Optional[float] = None,
    ) -> Tuple[jax.Array, jax.Array]:
        return _pq_sharded_topk(
            equery.lut,
            self.codes_t,
            mesh=self.mesh,
            axis=self.axis,
            k=k,
            count=self.count,
            num_chunks=self.num_chunks,
        )

    def score_candidates(self, equery: EncodedQueryPQ, cand) -> jax.Array:
        return _pq_sharded_score_candidates(
            equery.lut,
            self.codes_t,
            jnp.asarray(cand, jnp.int32),
            mesh=self.mesh,
            axis=self.axis,
            count=self.count,
            num_chunks=self.num_chunks,
        )

    def _centroid_distances(self) -> jax.Array:
        if getattr(self, "_cdist", None) is None:
            self._cdist = pq_ops.centroid_distance_table(
                self._c_chunks,
                distance_type=self.params.distance_type,
                invert=self.params.invert,
            )
        return self._cdist

    def score_internal_batch(self, ids_a, ids_b) -> jax.Array:
        """[P] stored-vs-stored scores via the replicated centroid-distance
        table (encoded_vectors.rs:34 / encoded_vectors_pq.rs semantics):
        each pair's code columns are gathered from their owning shards with
        one psum, then looked up replicated."""
        hi = max(self.count - 1, 0)
        return _pq_sharded_score_internal(
            jnp.clip(jnp.asarray(ids_a, jnp.int32), 0, hi),
            jnp.clip(jnp.asarray(ids_b, jnp.int32), 0, hi),
            self.codes_t,
            self._centroid_distances(),
            mesh=self.mesh,
            axis=self.axis,
            num_chunks=self.num_chunks,
        )

    # ----------------------------------------------------------- checkpoint
    def save(self, data_path, meta_path) -> None:
        import json
        import os

        meta_dir = os.path.dirname(os.fspath(meta_path))
        if meta_dir:
            os.makedirs(meta_dir, exist_ok=True)
        with open(meta_path, "w") as f:
            json.dump(self.metadata.to_json(), f)
        m = self.num_chunks
        bits4 = self.metadata.bits == 4
        row_size = (m + 1) // 2 if bits4 else m

        def writer(ct_np):
            rows = np.ascontiguousarray(ct_np[:m].T)
            if bits4:
                # Pack two 4-bit codes per byte — same on-disk layout as
                # the single-device ProductQuantizer.save, so sharded and
                # single-device blobs interoperate.
                if rows.shape[1] % 2:
                    rows = np.pad(rows, ((0, 0), (0, 1)))
                rows = (rows[:, 0::2] | (rows[:, 1::2] << 4)).astype(np.uint8)
            return rows

        self._write_blob_sharded(
            data_path,
            self.codes_t,
            axis_dim=1,
            row_writer=writer,
            row_size=row_size,
        )

    @classmethod
    def load(
        cls,
        data_path,
        meta_path,
        params: VectorParameters,
        mesh: Optional[Mesh] = None,
        axis: str = "shard",
    ) -> "ShardedProductQuantizer":
        import json
        import os

        mesh = mesh if mesh is not None else make_mesh()
        try:
            with open(meta_path) as f:
                meta = PQMetadata.from_json(json.load(f))
        except (OSError, json.JSONDecodeError, KeyError) as e:
            raise StorageIOError(f"cannot read metadata {meta_path}: {e}") from e
        m = len(meta.vector_division)
        n = params.count
        row_size = m if meta.bits == 8 else (m + 1) // 2
        expected = n * row_size
        actual_size = os.path.getsize(data_path)
        if actual_size != expected:
            raise StorageIOError(
                f"file size {actual_size} does not match expected {expected}"
            )
        mpad = max(m + (-m) % pq_ops.CHUNK_ALIGN, pq_ops.CHUNK_ALIGN)
        npad = cls._shard_dim_for(mesh, axis, n, pq_ops.ROW_ALIGN)
        mm = (
            np.memmap(data_path, np.uint8, "r").reshape(n, row_size)
            if n
            else None
        )

        def cb(index):
            sl = index[1]
            c0, c1 = sl.start or 0, sl.stop if sl.stop is not None else npad
            out = np.zeros((mpad, c1 - c0), np.uint8)
            v = max(0, min(c1, n) - c0)
            if v:
                rows = mm[c0 : c0 + v]
                if meta.bits == 4:
                    # Unpack nibble pairs (lo nibble = even chunk), mirroring
                    # ProductQuantizer.load.
                    un = np.empty((v, row_size * 2), np.uint8)
                    un[:, 0::2] = rows & 0x0F
                    un[:, 1::2] = rows >> 4
                    rows = un[:, :m]
                out[:m, :v] = rows.T
            return out

        codes_t = jax.make_array_from_callback(
            (mpad, npad), NamedSharding(mesh, P(None, axis)), cb
        )
        return cls._from_parts(codes_t, meta, mesh, axis)


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "axis", "k", "count", "num_chunks",
    ),
)
def _pq_sharded_topk(
    lut, codes_t, *, mesh, axis, k, count, num_chunks,
):
    def local(lut_rep, codes_t_shard):
        scores = pq_ops.score_lut_xla(
            lut_rep, codes_t_shard.T[:, :num_chunks]
        )
        return local_topk_merge(
            scores, axis, k, count,
        )

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, None, None), P(None, axis)),
        out_specs=(P(None, None), P(None, None)),
        check_vma=False,
    )
    return fn(lut, codes_t)


@partial(
    jax.jit, static_argnames=("mesh", "axis", "count", "num_chunks")
)
def _pq_sharded_score_candidates(
    lut, codes_t, cand, *, mesh, axis, count, num_chunks
):
    def local(lut_rep, ct_shard, cd):
        n_local = ct_shard.shape[1]
        shard_idx = jax.lax.axis_index(axis)
        local_ids = cd - shard_idx * n_local
        owned = (local_ids >= 0) & (local_ids < n_local) & (cd < count) & (
            cd >= 0
        )
        safe = jnp.clip(local_ids, 0, n_local - 1)
        scores = pq_ops.score_candidates_lut(
            lut_rep, ct_shard.T[:, :num_chunks], safe
        )
        return _owned_scores_psum(scores, owned, axis)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, None, None), P(None, axis), P(None, None)),
        out_specs=P(None, None),
        check_vma=False,
    )
    return fn(lut, codes_t, cand)


@partial(jax.jit, static_argnames=("mesh", "axis", "num_chunks"))
def _pq_sharded_score_internal(
    ia, ib, codes_t, cdist, *, mesh, axis, num_chunks
):
    def local(ia_r, ib_r, ct_shard, cd):
        n_local = ct_shard.shape[1]
        shard_idx = jax.lax.axis_index(axis)

        def code_rows(ids):
            lid = ids - shard_idx * n_local
            owned = (lid >= 0) & (lid < n_local)
            # u8 codes ride the psum as f32 (one non-zero contributor per
            # element, and 0..255 is exact in f32), then back to int.
            cols = _owned_rows_psum(
                ct_shard.astype(jnp.float32), lid, owned, axis, 1
            )  # [Mpad, P]
            return cols.T[:, :num_chunks].astype(jnp.int32)

        return pq_ops.score_internal_lut(cd, code_rows(ia_r), code_rows(ib_r))

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None), P(None), P(None, axis), P(None, None, None)),
        out_specs=P(None),
        check_vma=False,
    )
    return fn(ia, ib, codes_t, cdist)


# ------------------------------------------------------------ f32 rescorer


class ShardedExactRescorer:
    """f32 rescoring stage with the original vectors sharded over the
    points axis — the sharded counterpart of models.pipeline.ExactRescorer,
    for two-stage configurations whose f32 corpus exceeds one chip's HBM."""

    def __init__(
        self,
        data,
        distance_type: DistanceType,
        invert: bool,
        mesh: Optional[Mesh] = None,
        axis: str = "shard",
    ):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.axis = axis
        self._dt = distance_type
        self._invert = invert
        n_shards = self.mesh.shape[axis]
        data = np.asarray(data, np.float32)
        self.count = data.shape[0]
        npad = self.count + (-self.count) % n_shards
        self._data = jax.device_put(
            _pad_rows(data, max(npad, n_shards)),
            NamedSharding(self.mesh, P(axis, None)),
        )

    def encode_query(self, queries):
        q = jnp.asarray(queries, jnp.float32)
        return q[None, :] if q.ndim == 1 else q

    def score_candidates(self, equery, cand) -> jax.Array:
        return _exact_sharded_score_candidates(
            equery,
            self._data,
            jnp.asarray(cand, jnp.int32),
            mesh=self.mesh,
            axis=self.axis,
            count=self.count,
            distance_type=self._dt,
            invert=self._invert,
        )


@partial(
    jax.jit,
    static_argnames=("mesh", "axis", "count", "distance_type", "invert"),
)
def _exact_sharded_score_candidates(
    queries, data, cand, *, mesh, axis, count, distance_type, invert
):
    from ..core.distances import score as _score

    def local(q, d_shard, cd):
        n_local = d_shard.shape[0]
        shard_idx = jax.lax.axis_index(axis)
        local_ids = cd - shard_idx * n_local
        owned = (local_ids >= 0) & (local_ids < n_local) & (cd < count) & (
            cd >= 0
        )
        safe = jnp.clip(local_ids, 0, n_local - 1)
        g = jnp.take(d_shard, safe.reshape(-1), axis=0).reshape(
            cd.shape + (d_shard.shape[1],)
        )
        scores = _score(q[:, None, :], g, distance_type, invert)
        return _owned_scores_psum(scores, owned, axis)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, None), P(axis, None), P(None, None)),
        out_specs=P(None, None),
        check_vma=False,
    )
    return fn(queries, data, cand)
