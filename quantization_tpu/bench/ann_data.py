"""ANN benchmark datasets + measurement harness.

JAX port of demos/src/ann_benchmark_data.rs: the same metrics
vocabulary (recall ``same_10/same_20/same_30`` at ann_benchmark_data.rs:168-183,
latency min/avg/p95/p99/max at :202-220, encode wall-clock), the same HDF5
layout (train/test/neighbors/distances), and the same cosine preprocessing
(:223-230). This environment has no network egress, so instead of downloading
(ann_benchmark_data.rs:187-200) the loader reads a local HDF5 file when
present and otherwise generates a seeded clustered synthetic corpus of the
same shape — the harness and metrics are identical either way.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict

import numpy as np

from ..core.types import DistanceType


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    filename: str
    dim: int
    distance_type: DistanceType


# The reference's 11-dataset registry (demos/src/ann_benchmark.rs:46-102),
# keyed by the ann-benchmarks basename.
DATASETS: Dict[str, DatasetSpec] = {
    s.name: s
    for s in [
        DatasetSpec("glove-200-angular", "glove-200-angular.hdf5", 200, DistanceType.DOT),
        DatasetSpec("glove-100-angular", "glove-100-angular.hdf5", 100, DistanceType.DOT),
        DatasetSpec("glove-50-angular", "glove-50-angular.hdf5", 50, DistanceType.DOT),
        DatasetSpec("glove-25-angular", "glove-25-angular.hdf5", 25, DistanceType.DOT),
        DatasetSpec("deep-image-96-angular", "deep-image-96-angular.hdf5", 96, DistanceType.DOT),
        DatasetSpec("nytimes-256-angular", "nytimes-256-angular.hdf5", 256, DistanceType.DOT),
        DatasetSpec("lastfm-64-dot", "lastfm-64-dot.hdf5", 64, DistanceType.DOT),
        DatasetSpec("fashion-mnist-784-euclidean", "fashion-mnist-784-euclidean.hdf5", 784, DistanceType.L2),
        DatasetSpec("gist-960-euclidean", "gist-960-euclidean.hdf5", 960, DistanceType.L2),
        DatasetSpec("mnist-784-euclidean", "mnist-784-euclidean.hdf5", 784, DistanceType.L2),
        DatasetSpec("sift-128-euclidean", "sift-128-euclidean.hdf5", 128, DistanceType.L2),
    ]
}


def cosine_preprocess(data: np.ndarray) -> np.ndarray:
    """Row-normalize (ann_benchmark_data.rs:223-230) so dot == cosine."""
    norms = np.linalg.norm(data, axis=1, keepdims=True)
    norms[norms == 0] = 1.0
    return (data / norms).astype(np.float32)


def clustered_corpus(
    count: int, dim: int, queries: int, seed: int, block_rows: int = 1 << 18
):
    """Seeded ``(train f32[count, dim], test f32[queries, dim])``: 64
    gaussian centers with anisotropic spread give realistic (non-uniform)
    neighbor structure. Rows are drawn in blocks written in place, so peak
    host memory stays near the corpus itself at any count; the random
    stream is the same as one whole-corpus draw."""
    rng = np.random.default_rng(seed)
    n_centers = 64
    centers = rng.standard_normal((n_centers, dim)).astype(np.float32)
    scales = (0.3 + rng.random(n_centers, dtype=np.float32))[:, None]

    def draw(assign):
        out = np.empty((assign.shape[0], dim), np.float32)
        for b0 in range(0, assign.shape[0], block_rows):
            a = assign[b0 : b0 + block_rows]
            blk = rng.standard_normal((a.shape[0], dim), dtype=np.float32)
            blk *= scales[a]
            blk *= np.float32(0.5)
            blk += centers[a]
            out[b0 : b0 + a.shape[0]] = blk
        return out

    train = draw(rng.integers(0, n_centers, count))
    test = draw(rng.integers(0, n_centers, queries))
    return train, test


@dataclasses.dataclass
class AnnBenchmarkData:
    name: str
    distance_type: DistanceType
    train: np.ndarray  # [N, D] f32
    test: np.ndarray  # [Q, D] f32
    neighbors: np.ndarray  # [Q, >=30] int — exact top neighbors

    @classmethod
    def load(
        cls,
        spec: DatasetSpec,
        data_dir: str = "test_data",
        synthetic_count: int = 100_000,
        synthetic_queries: int = 100,
        seed: int = 42,
    ) -> "AnnBenchmarkData":
        path = os.path.join(data_dir, spec.filename)
        if os.path.exists(path):
            return cls.from_hdf5(spec, path)
        return cls.synthetic(
            spec, synthetic_count, synthetic_queries, seed
        )

    @classmethod
    def from_hdf5(cls, spec: DatasetSpec, path: str) -> "AnnBenchmarkData":
        import h5py

        with h5py.File(path, "r") as f:
            train = np.asarray(f["train"], dtype=np.float32)
            test = np.asarray(f["test"], dtype=np.float32)
            neighbors = np.asarray(f["neighbors"], dtype=np.int64)
        return cls(spec.name, spec.distance_type, train, test, neighbors)

    @classmethod
    def synthetic(
        cls, spec: DatasetSpec, count: int, queries: int, seed: int
    ) -> "AnnBenchmarkData":
        """Clustered gaussian corpus of the dataset's shape (see
        ``clustered_corpus``)."""
        train, test = clustered_corpus(count, spec.dim, queries, seed)
        data = cls(
            spec.name + "-synthetic",
            spec.distance_type,
            train,
            test,
            np.zeros((queries, 0), np.int64),
        )
        # Ground truth must reflect the metric actually benchmarked: angular
        # datasets are scored post-normalization, so normalize first
        # (normalization is idempotent, so the harness's later
        # preprocess_cosine() is a no-op).
        data.preprocess_cosine()
        data.neighbors = data.exact_neighbors(100)
        return data

    def preprocess_cosine(self) -> None:
        if self.distance_type == DistanceType.DOT:
            self.train = cosine_preprocess(self.train)
            self.test = cosine_preprocess(self.test)

    def exact_neighbors(self, k: int) -> np.ndarray:
        """Exact top-k ground truth, computed on device in query blocks."""
        import jax
        import jax.numpy as jnp

        from ..core.distances import pairwise_score

        invert = self.distance_type != DistanceType.DOT
        train_dev = jnp.asarray(self.train)
        out = []
        for start in range(0, self.test.shape[0], 64):
            q = jnp.asarray(self.test[start : start + 64])
            scores = pairwise_score(q, train_dev, self.distance_type, invert)
            _, idx = jax.lax.top_k(scores, k)
            out.append(np.asarray(idx))
        return np.concatenate(out, axis=0)


def same_count(a: np.ndarray, b: np.ndarray) -> int:
    return len(set(a.tolist()) & set(b.tolist()))


@dataclasses.dataclass
class KnnResult:
    same_10: float
    same_20: float
    same_30: float
    latencies_us: np.ndarray

    def timings(self) -> Dict[str, float]:
        """min/avg/p95/p99/max in microseconds
        (ann_benchmark_data.rs:202-220)."""
        lat = np.sort(self.latencies_us)
        p95 = min(int(len(lat) * 0.95), len(lat) - 1)
        p99 = min(int(len(lat) * 0.99), len(lat) - 1)
        return {
            "min_us": float(lat[0]),
            "avg_us": float(lat.mean()),
            "p95_us": float(lat[p95]),
            "p99_us": float(lat[p99]),
            "max_us": float(lat[-1]),
        }


def test_knn(
    data: AnnBenchmarkData,
    index,
    query_batch: int = 1,
    topk_method: str = "exact",
    recall_target=None,
) -> KnnResult:
    """Full-scan top-30 per query; recall@10/20/30 vs exact ground truth +
    per-batch latency (the reference's per-query loop,
    ann_benchmark_data.rs:123-185, batched)."""
    q_total = data.test.shape[0]
    same10 = same20 = same30 = 0.0
    latencies = []
    all_idx = []
    for start in range(0, q_total, query_batch):
        q = data.test[start : start + query_batch]
        t0 = time.perf_counter()
        eq = index.encode_query(q)
        if recall_target is None:
            _, idx = index.top_k(eq, 30, method=topk_method)
        else:
            _, idx = index.top_k(
                eq, 30, method=topk_method, recall_target=recall_target
            )
        idx = np.asarray(idx)
        latencies.append((time.perf_counter() - t0) * 1e6 / q.shape[0])
        all_idx.append(idx)
    idx = np.concatenate(all_idx, axis=0)
    gt = data.neighbors
    for qi in range(q_total):
        same10 += same_count(idx[qi, :10], gt[qi, :10])
        same20 += same_count(idx[qi, :20], gt[qi, :20])
        same30 += same_count(idx[qi, :30], gt[qi, :30])
    return KnnResult(
        same_10=same10 / (10 * q_total),
        same_20=same20 / (20 * q_total),
        same_30=same30 / (30 * q_total),
        latencies_us=np.asarray(latencies),
    )
