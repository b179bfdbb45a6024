"""Scalar u8 quantizer — the batched EncodedVectorsU8.

Re-design of quantization/src/encoded_vectors_u8.rs. Differences from the
reference are deliberate batch-first inversions (see SURVEY.md §7):

  * SoA storage on device — codes int8[N, D_pad] + offsets f32[N] — instead of
    per-row [f32 prefix | u8 codes] (encoded_vectors_u8.rs:78-116). The on-disk
    format keeps the reference's interleaved row layout for drop-in
    save/load compatibility (§3.5).
  * Batch scoring is the primitive: one int8 matmul produces [Q, N]
    scores; the reference scores one (query, point) per call.
  * On-disk rows use the reference's 16-aligned actual_dim
    (encoded_vectors_u8.rs:12,252-259) in both directions: files written
    here pass the reference's exact-size check and vice versa, with
    voffsets computed over the 16-aligned width exactly as the reference
    computes them. In memory, codes are zero-padded further to a multiple
    of 128 columns — zero-codes on both operands contribute exactly 0 to
    both integer kernels, so scores are unchanged.

Scoring math (parity with encoded_vectors_u8.rs:145-158,386-453):
    score(q, i)        = multiplier * kernel(Q, V_i) + q.offset + v_offset[i]
    score_internal(i,j)= multiplier * kernel(V_i, V_j) + off_i + off_j - diff
    diff               = actual_dim * offset^2   (negated when invert)
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.interface import (
    DataLike,
    EncodedVectors,
    iter_batches,
    validate_vector_parameters,
)
from ..core.storage import EncodedStorage
from ..core.types import (
    ArgumentsError,
    DistanceType,
    StorageIOError,
    VectorParameters,
    check_stop,
)
from ..ops import sq as sq_ops
from ..ops import topk as topk_ops
from ..ops.quantile import (
    QUANTILE_SAMPLE_SIZE,
    find_min_max_batches,
    find_quantile_interval,
    sample_rows,
)


@dataclass
class SQMetadata:
    """Serialized metadata — field names match the reference serde struct
    (encoded_vectors_u8.rs:24-31)."""

    actual_dim: int
    alpha: float
    offset: float
    multiplier: float
    vector_parameters: VectorParameters

    def to_json(self) -> dict:
        return {
            "actual_dim": self.actual_dim,
            "alpha": self.alpha,
            "offset": self.offset,
            "multiplier": self.multiplier,
            "vector_parameters": self.vector_parameters.to_json(),
        }

    @classmethod
    def from_json(cls, obj: dict) -> "SQMetadata":
        return cls(
            actual_dim=int(obj["actual_dim"]),
            alpha=float(obj["alpha"]),
            offset=float(obj["offset"]),
            multiplier=float(obj["multiplier"]),
            vector_parameters=VectorParameters.from_json(obj["vector_parameters"]),
        )


@dataclass
class EncodedQueryU8:
    """Encoded query batch: int8 codes [Q, D_lane] + f32 correction [Q]."""

    codes: jax.Array
    offsets: jax.Array


def _lane_pad(n: int) -> int:
    return n + (-n) % sq_ops.LANE



def calibrate_sq(
    batches_fn, params: VectorParameters, quantile, stop_condition, seed: int
):
    """Two-pass SQ calibration (encoded_vectors_u8.rs:57-71): full min/max
    scan, then an optional quantile interval over a <=100k-row sample.
    ``batches_fn`` is a zero-arg callable returning a fresh batch iterator.
    Returns (alpha, offset)."""
    mn, mx = find_min_max_batches(batches_fn())
    alpha, offset = sq_ops.alpha_offset_from_min_max(mn, mx)
    if quantile is not None:
        check_stop(stop_condition)
        sample = sample_rows(batches_fn, params.count, QUANTILE_SAMPLE_SIZE, seed)
        interval = find_quantile_interval(sample, params.count, float(quantile))
        if interval is not None:
            alpha, offset = sq_ops.alpha_offset_from_min_max(*interval)
    return alpha, offset


class ScalarQuantizerU8(EncodedVectors):
    """u8 affine codec with integer-matmul scoring."""

    def __init__(
        self,
        codes: jax.Array,
        voffsets: jax.Array,
        metadata: SQMetadata,
    ):
        # codes int8 [Npad, lane_dim]: rows >= count and cols >= actual_dim
        # are zero (zero-padding is score-neutral for both integer kernels).
        count = metadata.vector_parameters.count
        npad = count + (-count) % sq_ops.ROW_ALIGN
        if codes.shape[0] < npad:
            codes = jnp.pad(codes, ((0, npad - codes.shape[0]), (0, 0)))
            voffsets = jnp.pad(voffsets, (0, npad - voffsets.shape[0]))
        self.codes = codes
        self.voffsets = voffsets
        self.metadata = metadata
        # Device-resident multiplier: a fresh jnp scalar per call would be
        # one more host->device upload on every search.
        self._mult_dev = jnp.float32(metadata.multiplier)
        self.params = metadata.vector_parameters
        self.count = count

    # ------------------------------------------------------------------ train
    @classmethod
    def encode(
        cls,
        data: DataLike,
        params: VectorParameters,
        quantile: Optional[float] = None,
        stop_condition=None,
        batch_size: int = 65536,
        seed: int = 0,
        use_native: bool = False,
        max_threads: int = 1,
    ) -> "ScalarQuantizerU8":
        """Calibrate + encode (reference encode, encoded_vectors_u8.rs:34-140).

        Two passes over ``data`` (which may be a re-iterable batch stream):
        pass 1 scans min/max (+ optional quantile sample), pass 2 quantizes
        batch-by-batch on device with a cancellation check between batches.
        """
        if not callable(data):
            validate_vector_parameters(data, params)
        actual = sq_ops.actual_dim(params.dim)
        if params.count == 0:
            # Early-out with zeroed metadata (encoded_vectors_u8.rs:43-54).
            meta = SQMetadata(actual, 0.0, 0.0, 0.0, params)
            return cls(
                jnp.zeros((0, _lane_pad(actual)), jnp.int8),
                jnp.zeros((0,), jnp.float32),
                meta,
            )

        def batches():
            return iter_batches(data, batch_size)

        alpha, offset = calibrate_sq(batches, params, quantile, stop_condition, seed)

        dt, inv = params.distance_type, params.invert
        native = None
        if use_native:
            from ..native import loader as native_loader

            if native_loader.available():
                native = native_loader
        code_chunks, off_chunks = [], []
        total = 0

        def encode_one(batch):
            if batch.shape[1] != params.dim:
                raise ArgumentsError(
                    f"Vector length {batch.shape[1]} does not match vector "
                    f"parameters dim {params.dim}"
                )
            if native is not None:
                dt_index = [
                    DistanceType.DOT,
                    DistanceType.L1,
                    DistanceType.L2,
                ].index(dt)
                codes_np, voff_np = native.quantize_u8(
                    batch,
                    actual,
                    alpha,
                    offset,
                    sq_ops.pad_code(dt, alpha, offset),
                    dt_index,
                    inv,
                )
                return codes_np.view(np.int8), voff_np
            # Device path: codes STAY on device — only the f32 batch crosses
            # to the device; the int8 codes never round-trip back.
            return sq_ops.quantize_batch(
                jnp.asarray(batch),
                alpha=alpha,
                offset=offset,
                distance_type=dt,
                invert=inv,
                dpad=actual,
                lane=_lane_pad(actual),
            )

        lane = _lane_pad(actual)
        if native is not None and max_threads > 1:
            # Ordered parallel host ingestion — the condvar-ring equivalent
            # (utils/parallel_encode.py).
            from ..utils.parallel_encode import ordered_parallel_map

            for codes_np, voff_np in ordered_parallel_map(
                encode_one, batches(), max_threads, stop_condition
            ):
                code_chunks.append(codes_np)
                off_chunks.append(voff_np)
                total += codes_np.shape[0]
        elif native is not None:
            for batch in batches():
                check_stop(stop_condition)
                codes_np, voff_np = encode_one(batch)
                code_chunks.append(codes_np)
                off_chunks.append(voff_np)
                total += codes_np.shape[0]
        else:
            # Streaming device accumulation into a preallocated buffer —
            # peak HBM is the padded corpus itself, not 2x (list+concat).
            from ..utils.device_store import DeviceAppender

            npad = params.count + (-params.count) % sq_ops.ROW_ALIGN
            codes_app = DeviceAppender((npad, lane), jnp.int8)
            voff_app = DeviceAppender((npad,), jnp.float32)
            for batch in batches():
                check_stop(stop_condition)
                codes, voff = encode_one(batch)
                if total + codes.shape[0] > params.count:
                    raise ArgumentsError(
                        f"Vector count exceeds vector parameters count "
                        f"{params.count}"
                    )
                codes_app.append(codes)
                voff_app.append(voff)
                total += codes.shape[0]
        if total != params.count:
            raise ArgumentsError(
                f"Vector count {total} does not match vector parameters count "
                f"{params.count}"
            )

        if native is not None:
            codes_np = np.concatenate(code_chunks, axis=0)
            if lane > actual:
                codes_np = np.pad(codes_np, ((0, 0), (0, lane - actual)))
            codes_all = jnp.asarray(codes_np)
            offs_all = jnp.asarray(np.concatenate(off_chunks))
        else:
            codes_all = codes_app.finish()
            offs_all = voff_app.finish()
        multiplier = sq_ops.multiplier_for(dt, inv, alpha)
        meta = SQMetadata(actual, alpha, offset, multiplier, params)
        return cls(codes_all, offs_all, meta)

    # ------------------------------------------------------------------ query
    def encode_query(self, queries) -> EncodedQueryU8:
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

    # ------------------------------------------------------------------ score
    def score_batch(self, equery: EncodedQueryU8) -> jax.Array:
        return sq_ops.score_batch_xla(
            equery.codes,
            equery.offsets,
            self.codes[: self.count],
            self.voffsets[: self.count],
            self._mult_dev,
            distance_type=self.params.distance_type,
        )

    def top_k_device(
        self, equery: EncodedQueryU8, k: int, method: str = "exact",
        recall_target: Optional[float] = None,
    ):
        """Score + select. Beyond ``ops.topk.BLOCK_ROWS`` rows the corpus is
        scored and selected block by block, so peak memory is
        [Q, block] + codes, never [Q, N]; exact at any k.
        ``recall_target`` is accepted for interface parity and unused."""
        if self.count > topk_ops.BLOCK_ROWS:

            def score_block(b0, b1):
                return sq_ops.score_batch_xla(
                    equery.codes,
                    equery.offsets,
                    jax.lax.slice_in_dim(self.codes, b0, b1, axis=0),
                    jax.lax.slice_in_dim(self.voffsets, b0, b1, axis=0),
                    self._mult_dev,
                    distance_type=self.params.distance_type,
                )

            return topk_ops.blocked_topk(score_block, self.count, k, method)
        return super().top_k_device(equery, k, method=method)

    def score_points(self, equery: EncodedQueryU8, ids) -> jax.Array:
        ids = jnp.asarray(ids, jnp.int32)
        return sq_ops.score_batch_xla(
            equery.codes,
            equery.offsets,
            jnp.take(self.codes, ids, axis=0),
            jnp.take(self.voffsets, ids, axis=0),
            self._mult_dev,
            distance_type=self.params.distance_type,
        )

    def score_candidates(self, equery: EncodedQueryU8, cand) -> jax.Array:
        return sq_ops.score_candidates_xla(
            equery.codes,
            equery.offsets,
            self.codes,
            self.voffsets,
            jnp.asarray(cand, jnp.int32),
            self._mult_dev,
            distance_type=self.params.distance_type,
        )

    def _internal_diff(self) -> float:
        m = self.metadata
        diff = m.actual_dim * m.offset * m.offset
        return -diff if self.params.invert else diff

    def score_internal_batch(self, ids_a, ids_b) -> jax.Array:
        ids_a = jnp.asarray(ids_a, jnp.int32)
        ids_b = jnp.asarray(ids_b, jnp.int32)
        return sq_ops.score_internal_batch_xla(
            jnp.take(self.codes, ids_a, axis=0),
            jnp.take(self.voffsets, ids_a, axis=0),
            jnp.take(self.codes, ids_b, axis=0),
            jnp.take(self.voffsets, ids_b, axis=0),
            self._mult_dev,
            self._internal_diff(),
            distance_type=self.params.distance_type,
        )

    # ------------------------------------------------------------- checkpoint
    def get_quantized_vector_size(self) -> int:
        """Bytes per stored row in the on-disk format
        (encoded_vectors_u8.rs:252-255)."""
        return self.metadata.actual_dim + 4

    def save(self, data_path, meta_path) -> None:
        """Two-file save: JSON metadata + raw blob with the reference's
        interleaved [f32 offset | u8 codes] rows (§3.5)."""
        meta_dir = os.path.dirname(os.fspath(meta_path))
        if meta_dir:
            os.makedirs(meta_dir, exist_ok=True)
        with open(meta_path, "w") as f:
            json.dump(self.metadata.to_json(), f)

        m = self.metadata
        n = self.count
        codes_np = np.asarray(self.codes)[:n, : m.actual_dim]
        voff_np = np.asarray(self.voffsets, dtype=np.float32)[:n]
        rows = np.zeros((n, m.actual_dim + 4), dtype=np.uint8)
        if n:
            rows[:, :4] = voff_np.view(np.uint8).reshape(n, 4)
            rows[:, 4:] = codes_np.view(np.uint8)
        EncodedStorage(rows).save_to_file(data_path)

    @classmethod
    def load(
        cls, data_path, meta_path, params: VectorParameters
    ) -> "ScalarQuantizerU8":
        """Load; metadata is authoritative for semantics, ``params`` for sizing
        (the reference's asymmetry, §3.5)."""
        try:
            with open(meta_path) as f:
                meta = SQMetadata.from_json(json.load(f))
        except (OSError, json.JSONDecodeError, KeyError) as e:
            raise StorageIOError(f"cannot read metadata {meta_path}: {e}") from e
        row_size = meta.actual_dim + 4
        storage = EncodedStorage.from_file(data_path, row_size, params.count)
        rows = storage.data
        n = params.count
        if n:
            voff = rows[:, :4].copy().view(np.float32).reshape(n)
            codes = rows[:, 4:].view(np.int8)
        else:
            voff = np.zeros((0,), np.float32)
            codes = np.zeros((0, meta.actual_dim), np.int8)
        lane = _lane_pad(meta.actual_dim)
        if lane > meta.actual_dim:
            codes = np.pad(codes, ((0, 0), (0, lane - meta.actual_dim)))
        return cls(jnp.asarray(codes), jnp.asarray(voff), meta)


# Reference-parity alias.
EncodedVectorsU8 = ScalarQuantizerU8
