"""Product quantizer — the batched EncodedVectorsPQ.

Re-design of quantization/src/encoded_vectors_pq.rs. Training is one batched
k-means over every chunk at once (ops/kmeans.py) instead of a per-chunk rayon
loop; encode is a pure batched argmin (no condvar thread ring — storage order
is just array order); queries become [Q, m, 256] LUTs scored on device.

Reference constants preserved: 256 centroids/chunk, <=10k-vector training
sample, 100 iterations, 1e-5 accuracy (encoded_vectors_pq.rs:22-25); the
count<=256 fallback sets centroids to the points themselves zero-filled to 256
(rs:290-297).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

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
from ..ops import pq as pq_ops
from ..ops import topk as topk_ops
from ..ops.kmeans import kmeans_batched
from ..ops.quantile import sample_rows


@dataclass
class PQMetadata:
    """Field names match the reference serde struct
    (encoded_vectors_pq.rs:39-44); Range<usize> serializes as
    {"start", "end"}."""

    centroids: np.ndarray  # f32 [k, dim]
    vector_division: List[Tuple[int, int]]
    vector_parameters: VectorParameters
    bits: int = 8  # 8 (reference parity, 256 centroids) or 4 (Quick-ADC)
    # OPQ rotation f32[dim, dim] or None. Codes/centroids quantize
    # x @ rotation; key absent in reference-written files (ops/opq.py).
    rotation: Optional[np.ndarray] = None

    def to_json(self) -> dict:
        out = {
            "centroids": [
                [float(v) for v in row] for row in np.asarray(self.centroids)
            ],
            "vector_division": [
                {"start": s, "end": e} for s, e in self.vector_division
            ],
            "vector_parameters": self.vector_parameters.to_json(),
        }
        if self.bits != 8:
            out["bits"] = self.bits  # absent in reference-written files
        if self.rotation is not None:
            out["rotation"] = [
                [float(v) for v in row] for row in np.asarray(self.rotation)
            ]
        return out

    @classmethod
    def from_json(cls, obj: dict) -> "PQMetadata":
        rot = obj.get("rotation")
        return cls(
            centroids=np.asarray(obj["centroids"], dtype=np.float32),
            vector_division=[
                (int(r["start"]), int(r["end"])) for r in obj["vector_division"]
            ],
            vector_parameters=VectorParameters.from_json(obj["vector_parameters"]),
            bits=int(obj.get("bits", 8)),
            rotation=None if rot is None else np.asarray(rot, dtype=np.float32),
        )


@dataclass
class EncodedQueryPQ:
    """Per-query lookup table lut[Q, m, k]
    (reference EncodedQueryPQ, encoded_vectors_pq.rs:35-37)."""

    lut: jax.Array


class ProductQuantizer(EncodedVectors):
    """Chunked vector -> per-chunk nearest-centroid u8 codes, LUT scoring."""

    def __init__(self, codes: jax.Array, metadata: PQMetadata):
        # codes uint8 [Npad, Mpad]: rows >= count are zero, chunk columns
        # >= m are zero and never scored (scans slice to m chunks).
        npad, mpad = self._pads(metadata)
        if codes.shape[0] < npad or codes.shape[1] < mpad:
            codes = jnp.pad(
                codes,
                (
                    (0, npad - codes.shape[0]),
                    (0, mpad - codes.shape[1]),
                ),
            )
        self._codes = codes
        self._codes_t = None  # lazy — see the codes_t property
        self._init_common(metadata)

    @classmethod
    def from_transposed(
        cls, codes_t: jax.Array, metadata: PQMetadata
    ) -> "ProductQuantizer":
        """Construct with the TRANSPOSED [Mpad, Npad] layout as PRIMARY
        storage (chunk-major, as the sharded engines append codes).
        Row-major ``codes`` materializes lazily if a consumer asks (save,
        score_internal, a full scan); the IVF scan gathers its probed
        columns from this layout directly."""
        npad, mpad = cls._pads(metadata)
        if codes_t.shape[0] < mpad or codes_t.shape[1] < npad:
            codes_t = jnp.pad(
                codes_t,
                (
                    (0, mpad - codes_t.shape[0]),
                    (0, npad - codes_t.shape[1]),
                ),
            )
        obj = cls.__new__(cls)
        obj._codes = None
        obj._codes_t = codes_t
        obj._init_common(metadata)
        return obj

    @staticmethod
    def _pads(metadata: PQMetadata) -> tuple:
        count = metadata.vector_parameters.count
        m = len(metadata.vector_division)
        return (
            count + (-count) % pq_ops.ROW_ALIGN,
            m + (-m) % pq_ops.CHUNK_ALIGN,
        )

    def _init_common(self, metadata: PQMetadata) -> None:
        self.metadata = metadata
        self.params = metadata.vector_parameters
        self.count = metadata.vector_parameters.count
        self.num_chunks = len(metadata.vector_division)
        self._c_chunks = jnp.asarray(
            pq_ops.centroids_to_chunks(
                np.asarray(metadata.centroids), metadata.vector_division
            )
        )  # f32 [m, k, dmax]
        self._rot = (
            None
            if metadata.rotation is None
            else jnp.asarray(metadata.rotation, jnp.float32)
        )
        self._cdist: Optional[jax.Array] = None

    @property
    def codes(self) -> jax.Array:
        """Row-major [Npad, Mpad] codes; for transposed-first quantizers
        (``from_transposed``) this re-materializes by device transpose on
        first use — a full-size allocation capacity-scale callers should
        avoid (the IVF scan never needs it)."""
        if self._codes is None:
            self._codes = jnp.transpose(self._codes_t)
        return self._codes

    @property
    def codes_t(self) -> jax.Array:
        """Transposed copy [Mpad, Npad], built on first use and cached
        (the sharded engine's layout). Lazy because it doubles the
        resident code bytes."""
        if self._codes_t is None:
            self._codes_t = jnp.transpose(self._codes)
        return self._codes_t

    # ------------------------------------------------------------------ train
    @classmethod
    def encode(
        cls,
        data: DataLike,
        params: VectorParameters,
        chunk_size: int,
        stop_condition=None,
        batch_size: int = 16384,
        seed: int = 0,
        bits: int = 8,
        rotation=None,
    ) -> "ProductQuantizer":
        """k-means train + batched encode (encoded_vectors_pq.rs:56-107).

        ``bits=4`` trains 16 centroids per chunk (Quick-ADC style, a 16x
        smaller LUT per chunk, at a recall cost — use smaller chunk_size
        to compensate). 8 is reference parity.

        ``rotation`` enables OPQ (ops/opq.py — not in the reference):
        ``"opq"`` learns an orthogonal rotation on the training sample
        (eigen-allocation init + alternating Procrustes refinement); an
        explicit f32[dim, dim] orthogonal matrix is used as-is. Codes and
        centroids then quantize ``x @ R``; dot/L2 scores are unchanged by
        the rotation, L1 is not preserved and is rejected."""
        if bits not in (4, 8):
            raise ArgumentsError(f"bits must be 4 or 8, got {bits}")
        if rotation is not None and params.distance_type == DistanceType.L1:
            raise ArgumentsError(
                "OPQ rotation does not preserve L1 distances; use DOT or L2"
            )
        if not callable(data):
            validate_vector_parameters(data, params)
        division = pq_ops.get_vector_division(params.dim, chunk_size)
        k = pq_ops.CENTROIDS_COUNT if bits == 8 else pq_ops.CENTROIDS_COUNT4

        def batches():
            return iter_batches(data, batch_size)

        centroids, rot = cls._find_centroids(
            batches, division, params, stop_condition, seed, k,
            rotation=rotation,
        )

        c_chunks = jnp.asarray(pq_ops.centroids_to_chunks(centroids, division))
        rot_j = None if rot is None else jnp.asarray(rot)
        code_chunks = []
        total = 0
        for batch in batches():
            check_stop(stop_condition)
            if batch.shape[1] != params.dim:
                raise ArgumentsError(
                    f"Vector length {batch.shape[1]} does not match vector "
                    f"parameters dim {params.dim}"
                )
            if rot_j is not None:
                x_chunks = pq_ops.chunk_rows_device(
                    jnp.asarray(batch, jnp.float32) @ rot_j, division
                )
            else:
                x_chunks = jnp.asarray(pq_ops.chunk_tensor(batch, division))
            code_chunks.append(np.asarray(pq_ops.encode_batch(x_chunks, c_chunks)))
            total += batch.shape[0]
        if total != params.count:
            raise ArgumentsError(
                f"Vector count {total} does not match vector parameters count "
                f"{params.count}"
            )
        codes = (
            np.concatenate(code_chunks, axis=0)
            if code_chunks
            else np.zeros((0, len(division)), np.uint8)
        )
        meta = PQMetadata(centroids, division, params, bits=bits, rotation=rot)
        return cls(jnp.asarray(codes), meta)

    @classmethod
    def _find_centroids(
        cls, batches, division, params, stop_condition, seed,
        k=pq_ops.CENTROIDS_COUNT, rotation=None,
    ):
        """Sample + per-chunk k-means (encoded_vectors_pq.rs:278-342), run as
        one batched clustering over all chunks. Returns
        ``(centroids f32[k, dim], rotation f32[dim, dim] | None)``; with
        ``rotation`` the centroids live in the rotated space."""
        if params.count <= k:
            # Not enough vectors: centroids are the points themselves,
            # zero-filled to k (rs:290-297). OPQ has nothing to train here
            # (quantization is lossless), so "opq" degrades to identity; an
            # explicit matrix still applies.
            rows = [b for b in batches()]
            points = (
                np.concatenate(rows, axis=0)
                if rows
                else np.zeros((0, params.dim), np.float32)
            )
            rot = None
            if isinstance(rotation, np.ndarray) or (
                rotation is not None and not isinstance(rotation, str)
            ):
                rot = cls._check_rotation(rotation, params.dim)
                points = points @ rot
            centroids = np.zeros((k, params.dim), dtype=np.float32)
            centroids[: points.shape[0]] = points
            return centroids, rot
        check_stop(stop_condition)
        sample = sample_rows(
            batches, params.count, pq_ops.KMEANS_SAMPLE_SIZE, seed
        )
        if isinstance(rotation, str):
            if rotation != "opq":
                raise ArgumentsError(
                    f'rotation must be None, "opq", or a [dim, dim] matrix; '
                    f"got {rotation!r}"
                )
            from ..ops.opq import train_opq

            rot, centroids = train_opq(
                sample, division, k, seed=seed, stop_condition=stop_condition
            )
            return centroids, rot
        rot = None
        if rotation is not None:
            rot = cls._check_rotation(rotation, params.dim)
            sample = sample @ rot
        sample_chunks = jnp.asarray(pq_ops.chunk_tensor(sample, division))
        chunked = kmeans_batched(
            sample_chunks,
            k,
            max_iterations=pq_ops.KMEANS_MAX_ITERATIONS,
            accuracy=pq_ops.KMEANS_ACCURACY,
            seed=seed,
            stop_condition=stop_condition,
        )
        centroids = pq_ops.chunks_to_centroids(
            np.asarray(chunked), division, params.dim
        )
        return centroids, rot

    @staticmethod
    def _check_rotation(rotation, dim: int) -> np.ndarray:
        rot = np.asarray(rotation, dtype=np.float32)
        if rot.shape != (dim, dim):
            raise ArgumentsError(
                f"rotation shape {rot.shape} != ({dim}, {dim})"
            )
        if not np.allclose(rot @ rot.T, np.eye(dim), atol=1e-3):
            raise ArgumentsError("rotation matrix is not orthogonal")
        return rot

    # ------------------------------------------------------------------ query
    def encode_query(self, queries) -> EncodedQueryPQ:
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != self.params.dim:
            raise ArgumentsError(
                f"query dim {q.shape[1]} != corpus dim {self.params.dim}"
            )
        if self._rot is not None:
            # OPQ: queries rotate into code space on device (Q x D x D
            # matmul — negligible next to LUT build), then chunk there.
            # HIGHEST: a default-precision rotation perturbs the query at
            # data scale, which shifts every LUT entry coherently.
            q_chunks = pq_ops.chunk_rows_device(
                jnp.matmul(
                    jnp.asarray(q), self._rot,
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

    # ------------------------------------------------------------------ score
    def score_batch(self, equery: EncodedQueryPQ) -> jax.Array:
        return pq_ops.score_lut_xla(
            equery.lut, self.codes[: self.count, : self.num_chunks]
        )

    def top_k_device(
        self, equery: EncodedQueryPQ, k: int, method: str = "exact",
        recall_target: Optional[float] = None,
    ):
        """Score over the f32 LUT + select; beyond ``ops.topk.BLOCK_ROWS``
        rows block by block (exact at any k, [Q, block] peak memory).
        ``recall_target`` is accepted for interface parity and unused."""
        if self.count > topk_ops.BLOCK_ROWS:
            sub = self.codes[:, : self.num_chunks]

            def score_block(b0, b1):
                return pq_ops.score_lut_xla(
                    equery.lut, jax.lax.slice_in_dim(sub, b0, b1, axis=0)
                )

            return topk_ops.blocked_topk(score_block, self.count, k, method)
        return super().top_k_device(equery, k, method=method)

    def score_points(self, equery: EncodedQueryPQ, ids) -> jax.Array:
        ids = jnp.asarray(ids, jnp.int32)
        return pq_ops.score_lut_xla(
            equery.lut,
            jnp.take(self.codes[:, : self.num_chunks], ids, axis=0),
        )

    def score_candidates(self, equery: EncodedQueryPQ, cand) -> jax.Array:
        return pq_ops.score_candidates_lut(
            equery.lut,
            self.codes[:, : self.num_chunks],
            jnp.asarray(cand, jnp.int32),
        )

    def _centroid_distances(self) -> jax.Array:
        if self._cdist is None:
            self._cdist = pq_ops.centroid_distance_table(
                self._c_chunks,
                distance_type=self.params.distance_type,
                invert=self.params.invert,
            )
        return self._cdist

    def score_internal_batch(self, ids_a, ids_b) -> jax.Array:
        ids_a = jnp.asarray(ids_a, jnp.int32)
        ids_b = jnp.asarray(ids_b, jnp.int32)
        sub = self.codes[:, : self.num_chunks]
        return pq_ops.score_internal_lut(
            self._centroid_distances(),
            jnp.take(sub, ids_a, axis=0),
            jnp.take(sub, ids_b, axis=0),
        )

    # ----------------------------------------------------------------- debug
    def dump_to_image(self, data: np.ndarray, prefix: str = "kmeans") -> list:
        """Debug visualization: per-chunk scatter of the first two chunk
        dimensions, colored by assigned centroid, centroids in red — the
        port of the reference's `dump_image` feature
        (encoded_vectors_pq.rs:344-403). Returns the written paths."""
        from PIL import Image

        rng = np.random.default_rng(0)
        colors = rng.integers(0, 256, (pq_ops.CENTROIDS_COUNT, 3), dtype=np.uint8)
        data = np.asarray(data, dtype=np.float32)
        if self.metadata.rotation is not None:
            # Centroids live in the rotated (OPQ) space; plot there too.
            data = data @ np.asarray(self.metadata.rotation)
        mn, mx = float(data.min()), float(data.max())
        span = max(mx - mn, 1e-9)
        codes = np.asarray(self.codes[: self.count, : self.num_chunks])
        centroids = np.asarray(self.metadata.centroids)
        size = 1000
        paths = []
        for ci, (s, e) in enumerate(self.metadata.vector_division):
            if e - s < 2:
                continue
            img = np.full((size, size, 3), 255, dtype=np.uint8)
            xy = np.clip(
                ((data[:, [s, s + 1]] - mn) / span * size), 0, size - 1
            ).astype(np.int32)
            img[xy[:, 1], xy[:, 0]] = colors[codes[:, ci]]
            cxy = np.clip(
                ((centroids[:, [s, s + 1]] - mn) / span * size), 0, size - 2
            ).astype(np.int32)
            for dx in (0, 1):
                for dy in (0, 1):
                    img[cxy[:, 1] + dy, cxy[:, 0] + dx] = (255, 0, 0)
            path = f"{prefix}-{ci}.png"
            Image.fromarray(img).save(path)
            paths.append(path)
        return paths

    # ------------------------------------------------------------- checkpoint
    def get_quantized_vector_size(self) -> int:
        """One byte per chunk (encoded_vectors_pq.rs:109-114); 4-bit codes
        pack two chunks per byte on disk."""
        m = len(self.metadata.vector_division)
        return m if self.metadata.bits == 8 else (m + 1) // 2

    def save(self, data_path, meta_path) -> None:
        meta_dir = os.path.dirname(os.fspath(meta_path))
        if meta_dir:
            os.makedirs(meta_dir, exist_ok=True)
        with open(meta_path, "w") as f:
            json.dump(self.metadata.to_json(), f)
        rows = np.asarray(
            self.codes[: self.count, : self.num_chunks], dtype=np.uint8
        )
        if self.metadata.bits == 4:
            if rows.shape[1] % 2:
                rows = np.pad(rows, ((0, 0), (0, 1)))
            rows = (rows[:, 0::2] | (rows[:, 1::2] << 4)).astype(np.uint8)
        EncodedStorage(rows).save_to_file(data_path)

    @classmethod
    def load(cls, data_path, meta_path, params: VectorParameters) -> "ProductQuantizer":
        try:
            with open(meta_path) as f:
                meta = PQMetadata.from_json(json.load(f))
        except (OSError, json.JSONDecodeError, KeyError) as e:
            raise StorageIOError(f"cannot read metadata {meta_path}: {e}") from e
        m = len(meta.vector_division)
        row_size = m if meta.bits == 8 else (m + 1) // 2
        storage = EncodedStorage.from_file(data_path, row_size, params.count)
        rows = storage.data
        if meta.bits == 4:
            lo = rows & 0x0F
            hi = rows >> 4
            rows = np.empty((rows.shape[0], row_size * 2), np.uint8)
            rows[:, 0::2] = lo
            rows[:, 1::2] = hi
            rows = rows[:, :m]
        return cls(jnp.asarray(rows), meta)


# Reference-parity alias.
EncodedVectorsPQ = ProductQuantizer
