"""Ordered parallel host-side encoding.

The reference encodes PQ on a ring of worker threads whose commits to the
append-only storage are serialized by a chain of condition variables
(`ConditionalVariable`, lib.rs:41-75; ring at encoded_vectors_pq.rs:168-226),
with two safety properties pinned by tests:
  * cooperative cancellation mid-stream (tests/stop_condition.rs)
  * no leaked/blocked threads when a worker panics (test_pq.rs:275-331)

The *device* encode path needs none of this (batch order is array
order), but the host-side native ingestion path still wants thread
parallelism. ``ordered_parallel_map`` provides it with the same contract:
results are committed strictly in input order, a worker exception cancels the
remaining work and propagates, and ``stop_condition`` aborts between items —
implemented with a thread pool + in-order future consumption instead of a
condvar ring (the consumption order itself provides the ordering guarantee).
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
from typing import Callable, Iterable, Iterator, TypeVar

from ..core.types import StoppedError

T = TypeVar("T")
R = TypeVar("R")


def ordered_parallel_map(
    fn: Callable[[T], R],
    items: Iterable[T],
    max_threads: int = 4,
    stop_condition: Callable[[], bool] = None,
    prefetch: int = None,
) -> Iterator[R]:
    """Yield ``fn(item)`` for each item, in order, computed by a worker pool.

    Guarantees:
      * commit order == input order (the reference's condvar-ring invariant)
      * ``StoppedError`` raised promptly when stop_condition fires
      * a worker exception propagates and cancels outstanding work; no
        threads are leaked (pool teardown joins workers)
    """
    max_threads = max(1, int(max_threads))
    if prefetch is None:
        prefetch = 2 * max_threads
    cancelled = threading.Event()

    def guarded(item):
        if cancelled.is_set():
            raise StoppedError("cancelled")
        if stop_condition is not None and stop_condition():
            raise StoppedError("encoding stopped by stop_condition")
        return fn(item)

    with cf.ThreadPoolExecutor(
        max_workers=max_threads, thread_name_prefix="qtpu-encode"
    ) as pool:
        pending = []
        it = iter(items)
        try:
            exhausted = False
            while True:
                while not exhausted and len(pending) < prefetch:
                    if stop_condition is not None and stop_condition():
                        raise StoppedError("encoding stopped by stop_condition")
                    try:
                        item = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    pending.append(pool.submit(guarded, item))
                if not pending:
                    break
                fut = pending.pop(0)
                yield fut.result()  # in-order commit; re-raises worker errors
        except BaseException:
            cancelled.set()
            for fut in pending:
                fut.cancel()
            raise
