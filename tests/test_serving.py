"""PipelinedSearcher (quantization_tpu/serving.py): the pipelined
serving loop as product API.

Pinned: FIFO depth semantics (a result returns exactly ``depth``
submissions later), result equality with the direct blocking path for
every family (SQ / IVF / two-stage / plan-built / sharded), the
generator form, and the one-shot blocking ``search``."""

import numpy as np
import pytest

from quantization_tpu.core.types import (
    ArgumentsError,
    DistanceType,
    VectorParameters,
)
from quantization_tpu.models.ivf import IVFIndex
from quantization_tpu.models.pipeline import ExactRescorer, TwoStageIndex
from quantization_tpu.models.sq import ScalarQuantizerU8
from quantization_tpu.policy import recommend
from quantization_tpu.serving import PipelinedSearcher

DIM = 48
K = 10


def clustered(rng, count, dim, clusters=24, sigma=0.3):
    centers = rng.standard_normal((clusters, dim)).astype(np.float32)
    assign = rng.integers(0, clusters, count)
    return (
        centers[assign]
        + sigma * rng.standard_normal((count, dim)).astype(np.float32)
    ).astype(np.float32)


def _batches(rng, n, q=8):
    return [clustered(rng, q, DIM) for _ in range(n)]


@pytest.fixture
def corpus(rng):
    count = 6000
    data = clustered(rng, count, DIM)
    params = VectorParameters(DIM, count, DistanceType.DOT, False)
    return data, params


def test_depth_semantics_and_fifo(rng, corpus):
    data, params = corpus
    sq = ScalarQuantizerU8.encode(data, params)
    depth = 3
    s = PipelinedSearcher(sq, k=K, depth=depth)
    batches = _batches(rng, 7)
    direct = [sq.top_k(sq.encode_query(b), K) for b in batches]
    got = []
    for i, b in enumerate(batches):
        out = s.submit(b)
        # The first `depth` submissions return nothing; afterwards each
        # submit returns the result from exactly `depth` batches ago.
        assert (out is None) == (i < depth)
        if out is not None:
            got.append(out)
    assert s.in_flight == depth
    got.extend(s.flush())
    assert s.in_flight == 0
    assert len(got) == len(batches)
    for (gs, gi), (ds, di) in zip(got, direct):
        np.testing.assert_array_equal(gi, di)
        np.testing.assert_allclose(gs, ds, rtol=1e-6)


def test_search_stream_orders_and_counts(rng, corpus):
    data, params = corpus
    sq = ScalarQuantizerU8.encode(data, params)
    batches = _batches(rng, 5)
    s = PipelinedSearcher(sq, k=K, depth=8)  # depth > #batches: all flush
    results = list(s.search_stream(batches))
    assert len(results) == len(batches)
    for b, (_, gi) in zip(batches, results):
        _, di = sq.top_k(sq.encode_query(b), K)
        np.testing.assert_array_equal(gi, di)


def test_blocking_search_and_warmup(rng, corpus):
    data, params = corpus
    sq = ScalarQuantizerU8.encode(data, params)
    s = PipelinedSearcher(sq, k=K, depth=4)
    q = clustered(rng, 8, DIM)
    s.warmup(q)
    assert s.in_flight == 0
    gs, gi = s.search(q)
    _, di = sq.top_k(sq.encode_query(q), K)
    np.testing.assert_array_equal(gi, di)
    assert s.in_flight == 0


def test_knobs_pass_through_ivf(rng, corpus):
    data, params = corpus
    ivf = IVFIndex.encode(data, params, quantizer="sq", bucket_size=64)
    nb = ivf.metadata.nbuckets
    q = clustered(rng, 8, DIM)
    s = PipelinedSearcher(ivf, k=K, depth=2, nscan=nb, method="exact")
    gs, gi = s.search(q)
    ds, di = ivf.top_k(ivf.encode_query(q), K, nscan=nb, method="exact")
    np.testing.assert_array_equal(gi, di)


def test_two_stage_and_plan_serve(rng, corpus):
    data, params = corpus
    ivf = IVFIndex.encode(data, params, quantizer="sq", bucket_size=64)
    queries = clustered(rng, 8, DIM)
    plan = recommend(
        ivf, 0.95, k=K, queries=queries, data=data, q_batch=8
    )
    searcher = plan.serve(ivf, data, k=K, depth=2)
    assert isinstance(searcher, PipelinedSearcher)
    direct = plan.build(ivf, data, k=K)
    batches = _batches(rng, 4)
    for b, (_, gi) in zip(batches, searcher.search_stream(batches)):
        _, di = direct.top_k(direct.encode_query(b), K)
        np.testing.assert_array_equal(gi, di)
    # Manual TwoStageIndex works too.
    ts = TwoStageIndex(
        ivf, ExactRescorer(data, params.distance_type, params.invert),
        oversampling=4.0,
    )
    s2 = PipelinedSearcher(ts, k=K, depth=2)
    _, gi = s2.search(queries)
    _, di = ts.top_k(ts.encode_query(queries), K)
    np.testing.assert_array_equal(gi, di)


def test_sharded_engine(rng, corpus):
    from quantization_tpu.parallel.sharded import make_mesh
    from quantization_tpu.parallel.sharded_ivf import ShardedIVF

    data, params = corpus
    sivf = ShardedIVF(
        IVFIndex.encode(data, params, quantizer="sq", bucket_size=64),
        make_mesh(),
    )
    s = PipelinedSearcher(sivf, k=K, depth=2)
    batches = _batches(rng, 4)
    for b, (_, gi) in zip(batches, s.search_stream(batches)):
        _, di = sivf.top_k(sivf.encode_query(b), K)
        np.testing.assert_array_equal(gi, di)


def test_materialize_false_returns_device_arrays(rng, corpus):
    # materialize=False hands back device arrays (for a downstream device
    # stage); values match the materialized path exactly.
    import jax

    data, params = corpus
    sq = ScalarQuantizerU8.encode(data, params)
    s = PipelinedSearcher(sq, k=K, depth=2, materialize=False)
    q = clustered(rng, 8, DIM)
    gs, gi = s.search(q)
    assert isinstance(gi, jax.Array)
    _, di = sq.top_k(sq.encode_query(q), K)
    np.testing.assert_array_equal(np.asarray(gi), di)


def test_sync_keeps_results_queued(rng, corpus):
    # sync() blocks until in-flight work completes but drains nothing —
    # the measurement/quiesce barrier (bench harnesses bracket their
    # timed windows with it).
    data, params = corpus
    sq = ScalarQuantizerU8.encode(data, params)
    s = PipelinedSearcher(sq, k=K, depth=8)
    batches = _batches(rng, 3)
    for b in batches:
        s.submit(b)
    assert s.in_flight == 3
    s.sync()
    assert s.in_flight == 3  # nothing drained
    for b, (_, gi) in zip(batches, s.flush()):
        _, di = sq.top_k(sq.encode_query(b), K)
        np.testing.assert_array_equal(gi, di)
    s.sync()  # no-op on an empty pipe


def test_sync_waits_on_every_pending_result(rng, corpus, monkeypatch):
    # sync() waits on EVERY in-flight result, not just the newest: a
    # sharded engine's searches run on several devices' streams, which
    # need not finish in submission order.
    import jax

    import quantization_tpu.serving as serving_mod
    from quantization_tpu.parallel.sharded import (
        ShardedScalarQuantizer,
        make_mesh,
    )

    data, params = corpus
    ssq = ShardedScalarQuantizer(ScalarQuantizerU8.encode(data, params), make_mesh(4))
    s = PipelinedSearcher(ssq, k=K, depth=8)
    for b in _batches(rng, 3):
        s.submit(b)
    waited = []
    real = jax.block_until_ready
    monkeypatch.setattr(
        serving_mod.jax, "block_until_ready",
        lambda x: waited.append(x) or real(x),
    )
    s.sync()
    leaves = jax.tree_util.tree_leaves(waited)
    pending = jax.tree_util.tree_leaves(list(s._pending))
    assert len(pending) == 6 and all(any(p is w for w in leaves) for p in pending)
    assert all(p.is_ready() for p in pending)
    assert s.in_flight == 3


def test_argument_errors(corpus):
    data, params = corpus
    sq = ScalarQuantizerU8.encode(data, params)
    with pytest.raises(ArgumentsError):
        PipelinedSearcher(sq, depth=0)
    with pytest.raises(ArgumentsError):
        PipelinedSearcher(object())
