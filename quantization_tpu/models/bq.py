"""Binary quantizer — the batched EncodedVectorsBin.

Re-design of quantization/src/encoded_vectors_binary.rs: sign-bit packing
(v > 0 -> 1) scored by XOR + popcount, with the Hamming count mapped onto the
dot/L1/L2 score contract. Device layout is bit-plane uint32[W, N] (corpus axis
minor); the on-disk blob keeps the reference's row-major packed-bytes
layout with its word-size tiers (``store_type`` = "u8" | "u128" reproduces the
two BitsStoreType instantiations, encoded_vectors_binary.rs:44-160).
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
    StorageIOError,
    VectorParameters,
    check_stop,
)
from ..ops import bq as bq_ops
from ..ops import topk as topk_ops


@dataclass
class BQMetadata:
    """Reference metadata is just the vector parameters
    (encoded_vectors_binary.rs:21-24)."""

    vector_parameters: VectorParameters

    def to_json(self) -> dict:
        return {"vector_parameters": self.vector_parameters.to_json()}

    @classmethod
    def from_json(cls, obj: dict) -> "BQMetadata":
        return cls(VectorParameters.from_json(obj["vector_parameters"]))


@dataclass
class EncodedQueryBin:
    """Bit-packed query batch: uint32 words [Q, W]."""

    planes: jax.Array


class BinaryQuantizer(EncodedVectors):
    """Sign-bit codec with XOR-popcount scoring."""

    def __init__(
        self,
        planes: jax.Array,  # uint32 [W, Npad] bit-plane layout
        metadata: BQMetadata,
        store_type: str = "u128",
    ):
        # Pad the corpus axis and the plane-word axis to the layout's
        # alignment (zero words XOR to zero popcount, zero columns are
        # sliced off by count).
        count = metadata.vector_parameters.count
        npad = count + (-count) % bq_ops.ROW_ALIGN
        pad_w = (-planes.shape[0]) % bq_ops.WORD_ALIGN
        pad_n = npad - planes.shape[1] if planes.shape[1] < npad else 0
        if pad_w or pad_n:
            # Guarded: an unconditional jnp.pad is a full copy even with
            # zero-width pads — at the 100M capacity scale that is a ~9 GiB
            # transient holding 2x the planes live (the difference between
            # fitting and OOM on one chip). Pre-padded inputs skip it.
            planes = jnp.pad(planes, ((0, pad_w), (0, pad_n)))
        self.planes = planes
        self.metadata = metadata
        self.params = metadata.vector_parameters
        self.store_type = store_type
        self.count = count

    # ------------------------------------------------------------------ train
    @classmethod
    def encode(
        cls,
        data: DataLike,
        params: VectorParameters,
        stop_condition=None,
        batch_size: int = 65536,
        store_type: str = "u128",
        use_native: bool = False,
        max_threads: int = 1,
    ) -> "BinaryQuantizer":
        """Pack sign bits batch-by-batch (encoded_vectors_binary.rs:165-191)
        with a cancellation check between batches; optionally via the native
        C++ packer, optionally on an ordered worker pool."""
        if not callable(data):
            validate_vector_parameters(data, params)
        row_bytes = bq_ops.storage_bytes(params.dim, store_type)
        native = None
        if use_native:
            from ..native import loader as native_loader

            if native_loader.available():
                native = native_loader

        def pack_one(batch):
            if batch.shape[1] != params.dim:
                raise ArgumentsError(
                    f"Vector length {batch.shape[1]} does not match vector "
                    f"parameters dim {params.dim}"
                )
            if native is not None and row_bytes > 0:
                return native.pack_bits(batch, row_bytes)
            return bq_ops.pack_rows(batch, row_bytes)

        chunks = []
        total = 0
        if native is not None and max_threads > 1:
            from ..utils.parallel_encode import ordered_parallel_map

            for rows in ordered_parallel_map(
                pack_one, iter_batches(data, batch_size), max_threads,
                stop_condition,
            ):
                chunks.append(rows)
                total += rows.shape[0]
        else:
            for batch in iter_batches(data, batch_size):
                check_stop(stop_condition)
                chunks.append(pack_one(batch))
                total += batch.shape[0]
        if total != params.count:
            raise ArgumentsError(
                f"Vector count {total} does not match vector parameters count "
                f"{params.count}"
            )
        rows = (
            np.concatenate(chunks, axis=0)
            if chunks
            else np.zeros((0, row_bytes), np.uint8)
        )
        planes = bq_ops.rows_to_planes(rows)
        return cls(jnp.asarray(planes), BQMetadata(params), store_type)

    # ------------------------------------------------------------------ query
    def encode_query(self, queries) -> EncodedQueryBin:
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
        if words.shape[1] < w8:  # match the stored planes' padded word count
            words = np.pad(words, ((0, 0), (0, w8 - words.shape[1])))
        return EncodedQueryBin(jnp.asarray(words))

    # ------------------------------------------------------------------ score
    def score_batch(self, equery: EncodedQueryBin) -> jax.Array:
        return bq_ops.score_batch_xla(
            equery.planes,
            self.planes[:, : self.count],
            distance_type=self.params.distance_type,
            invert=self.params.invert,
            dim=self.params.dim,
        )

    def top_k_device(
        self, equery: EncodedQueryBin, k: int, method: str = "exact",
        recall_target: Optional[float] = None,
    ):
        """Score + select; beyond ``ops.topk.BLOCK_ROWS`` rows block by
        block (exact at any k, [Q, block] peak memory). The coarse stage
        of two-stage retrieval scans the full corpus, so this is where the
        score-matrix memory wall bites first. ``recall_target`` is
        accepted for interface parity and unused."""
        if self.count > topk_ops.BLOCK_ROWS:

            def score_block(b0, b1):
                return bq_ops.score_batch_xla(
                    equery.planes,
                    jax.lax.slice_in_dim(self.planes, b0, b1, axis=1),
                    distance_type=self.params.distance_type,
                    invert=self.params.invert,
                    dim=self.params.dim,
                )

            return topk_ops.blocked_topk(score_block, self.count, k, method)
        return super().top_k_device(equery, k, method=method)

    def score_points(self, equery: EncodedQueryBin, ids) -> jax.Array:
        ids = jnp.asarray(ids, jnp.int32)
        sub = jnp.take(self.planes, ids, axis=1)
        return bq_ops.score_batch_xla(
            equery.planes,
            sub,
            distance_type=self.params.distance_type,
            invert=self.params.invert,
            dim=self.params.dim,
        )

    def score_candidates(self, equery: EncodedQueryBin, cand) -> jax.Array:
        return bq_ops.score_candidates_xla(
            equery.planes,
            self.planes,
            jnp.asarray(cand, jnp.int32),
            distance_type=self.params.distance_type,
            invert=self.params.invert,
            dim=self.params.dim,
        )

    def score_internal_batch(self, ids_a, ids_b) -> jax.Array:
        ids_a = jnp.asarray(ids_a, jnp.int32)
        ids_b = jnp.asarray(ids_b, jnp.int32)
        a = jnp.take(self.planes, ids_a, axis=1)  # [W, P]
        b = jnp.take(self.planes, ids_b, axis=1)
        xor = jnp.sum(
            jax.lax.population_count(jnp.bitwise_xor(a, b)).astype(jnp.int32),
            axis=0,
        )
        return bq_ops.metric_from_xor(
            xor,
            distance_type=self.params.distance_type,
            invert=self.params.invert,
            dim=self.params.dim,
        )

    # ------------------------------------------------------------- checkpoint
    def get_quantized_vector_size(self) -> int:
        return bq_ops.storage_bytes(self.params.dim, self.store_type)

    def save(self, data_path, meta_path) -> None:
        meta_dir = os.path.dirname(os.fspath(meta_path))
        if meta_dir:
            os.makedirs(meta_dir, exist_ok=True)
        with open(meta_path, "w") as f:
            json.dump(self.metadata.to_json(), f)
        rows = bq_ops.planes_to_rows(
            np.asarray(self.planes)[:, : self.count],
            self.get_quantized_vector_size(),
        )
        EncodedStorage(rows).save_to_file(data_path)

    @classmethod
    def load(
        cls,
        data_path,
        meta_path,
        params: VectorParameters,
        store_type: str = "u128",
    ) -> "BinaryQuantizer":
        try:
            with open(meta_path) as f:
                meta = BQMetadata.from_json(json.load(f))
        except (OSError, json.JSONDecodeError, KeyError) as e:
            raise StorageIOError(f"cannot read metadata {meta_path}: {e}") from e
        row_bytes = bq_ops.storage_bytes(params.dim, store_type)
        storage = EncodedStorage.from_file(data_path, row_bytes, params.count)
        planes = bq_ops.rows_to_planes(storage.data)
        return cls(jnp.asarray(planes), meta, store_type)


# Reference-parity alias.
EncodedVectorsBin = BinaryQuantizer
