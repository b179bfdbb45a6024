"""Pipelined serving loop — the chained-dispatch pattern as product API.

The reference's product surface is point-at-a-time scoring
(`quantization/src/encoded_vectors.rs:32`: the caller loops
`score_point` per candidate). The batched equivalent of that serving
contract is NOT a blocking per-call wrapper: every quantizer here
already exposes `top_k_device` (async dispatch, device-resident
results), and the throughput/latency the engine is capable of is only
realized when the device stream stays deep — N independent searches
enqueued, results drained as they complete.

**The blocking-wrapper trap:** calling `index.top_k(eq, k)` per query
waits for each search to finish and copy back before the next is
enqueued, so the device idles through every host step between searches.
:class:`PipelinedSearcher` owns the fix: keep ``depth`` searches in
flight, return results one behind, and the per-query cost approaches the
device time.

Works over anything with ``encode_query`` + ``top_k_device``: the
quantizers (SQ/PQ/BQ), ``IVFIndex``, ``TwoStageIndex``, the sharded
engines, and ``ServingPlan.build(...)`` results (``_MethodPinned``).

Usage — request loop (one batch in, one batch out, pipelined)::

    searcher = PipelinedSearcher(index, k=10, depth=8)
    for queries in request_stream:          # each [Q, D] float32
        done = searcher.submit(queries)     # returns an OLDER result
        if done is not None:                #   once the pipe is full
            emit(done)
    for done in searcher.flush():
        emit(done)

or the generator form::

    for scores, ids in searcher.search_stream(request_stream):
        ...

`search(queries)` is the deliberately-blocking one-shot (drains the
whole pipe; per-call latency, not throughput — fine for interactive
use, wrong inside a serving loop).
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator, Optional, Tuple

import jax
import numpy as np

from .core.types import ArgumentsError

__all__ = ["PipelinedSearcher"]


class PipelinedSearcher:
    """Keep ``depth`` independent searches in flight on the device stream.

    ``index``: any searchable with ``encode_query`` and ``top_k_device``
    (quantizer, IVF index, two-stage pipeline, sharded engine, or a
    built :class:`~quantization_tpu.policy.ServingPlan`). ``knobs`` pass
    through to every ``top_k_device`` call (e.g. ``method="approx"``,
    ``nscan=...`` for IVF) — leave them empty for plan-built objects,
    which pin their own.

    ``depth`` trades result latency for throughput: a submitted batch's
    result returns ``depth`` submissions later (or at ``flush``).
    Results are FIFO — submission order.

    ``materialize`` (default True) converts drained results to numpy.
    Loops that feed results to a downstream device stage can pass
    ``materialize=False`` and keep device arrays.

    Keep the query-batch SHAPE fixed across submissions: each distinct
    [Q, D] shape compiles its own executable on first use (``warmup``
    pre-pays this).
    """

    def __init__(
        self, index, *, k: int = 10, depth: int = 8,
        materialize: bool = True, **knobs,
    ):
        if depth < 1:
            raise ArgumentsError("depth must be >= 1")
        if not hasattr(index, "top_k_device") or not hasattr(
            index, "encode_query"
        ):
            raise ArgumentsError(
                "index must expose encode_query and top_k_device "
                f"(got {type(index).__name__})"
            )
        self._ix = index
        self._k = int(k)
        self._depth = int(depth)
        self._materialize = bool(materialize)
        self._knobs = knobs
        self._pending: deque = deque()

    # ------------------------------------------------------------ core
    @property
    def in_flight(self) -> int:
        return len(self._pending)

    def submit(
        self, queries, *, encoded: bool = False
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Enqueue one search; return the OLDEST completed result once
        more than ``depth`` are in flight, else None. Never blocks on
        the search just submitted.

        ``encoded=True`` submits a pre-encoded query (the result of
        ``index.encode_query``) — worth it when the same encoded batch
        is re-searched: it saves the encode dispatches."""
        eq = queries if encoded else self._ix.encode_query(queries)
        out = self._ix.top_k_device(eq, self._k, **self._knobs)
        self._pending.append(out)
        if len(self._pending) > self._depth:
            return self._drain_one()
        return None

    def flush(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Drain every in-flight search, oldest first."""
        while self._pending:
            yield self._drain_one()

    def sync(self) -> None:
        """Block until every in-flight search has COMPLETED on device
        (results stay queued — nothing is drained). Useful to bound a
        measurement window or quiesce before a checkpoint. Waits on every
        pending result, not only the newest: searches over a sharded
        engine run on several devices' streams, which need not finish in
        submission order."""
        jax.block_until_ready(list(self._pending))

    def search_stream(
        self, query_batches: Iterable
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Pipelined map over a stream of query batches: yields one
        (scores, ids) per batch, in order, keeping ``depth`` in
        flight."""
        for q in query_batches:
            done = self.submit(q)
            if done is not None:
                yield done
        yield from self.flush()

    def search(
        self, queries, *, encoded: bool = False
    ) -> Tuple[np.ndarray, np.ndarray]:
        """One-shot BLOCKING search: drains the whole pipe (in-flight
        results are discarded by design — use submit/flush to keep
        them). This measures per-call latency; inside a serving loop use
        ``submit``/``search_stream`` instead (the blocking-wrapper trap in
        the module docstring)."""
        for _ in self.flush():
            pass
        self.submit(queries, encoded=encoded)
        return next(self.flush())

    def warmup(self, queries, *, encoded: bool = False) -> None:
        """Compile the search for this query-batch shape (a cold compile
        can take seconds); the result is discarded and the pipe left
        empty."""
        self.submit(queries, encoded=encoded)
        for _ in self.flush():
            pass

    # ------------------------------------------------------------ impl
    def _drain_one(self) -> Tuple[np.ndarray, np.ndarray]:
        s, i = self._pending.popleft()
        if self._materialize:
            return np.asarray(s), np.asarray(i)
        return s, i
