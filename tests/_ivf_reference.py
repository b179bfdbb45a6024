"""Plain numpy reference for IVF searches: score every slot of the scanned
buckets with the family's formula in float64, map slots to ids, keep each
id's best slot, select the top k. Shared by test_ivf.py and
test_sharded_ivf.py, which compare the engines' ``top_k`` with it over the
same union of buckets."""

import jax
import jax.numpy as jnp
import numpy as np

from quantization_tpu.core.types import DistanceType
from quantization_tpu.models.ivf import _bucket_priority, _residual_coeffs

NEG = -3.0e38


def union_buckets(means, queries, dt, invert, p, u):
    """The ``u`` buckets a batch-union probe of ``p`` votes per query
    scans (the probe the engines run; the scan is what is under test)."""
    prio = _bucket_priority(jnp.asarray(queries), jnp.asarray(means), dt, invert, p)
    return np.asarray(jax.lax.top_k(prio, u)[1])


def _unpack_bits(planes):
    """uint32 planes [W, N] -> 0/1 bits [N, W*32] (little-endian words)."""
    words = np.ascontiguousarray(np.asarray(planes).T)
    return np.unpackbits(words.view(np.uint8), axis=1, bitorder="little")


def slot_scores(kind, eq, inner, slots, *, dim, dt=None, invert=False):
    """float64 [Q, len(slots)] inner scores of the given slots.

    ``eq`` / ``inner`` are the engine's per-family array tuples: SQ
    ``(qcodes, qoff)`` / ``(codes, voff, mult)``; BQ ``(qplanes,)`` or the
    residual ``(qs, mult, qb)`` / ``(planes,)``; PQ ``(lut,)`` /
    ``(codes [N, m],)`` or ``(codes, rowadd)``."""
    if kind == "sq":
        qc, qoff = (np.asarray(a) for a in eq)
        codes, voff, mult = (np.asarray(a) for a in inner)
        raw = qc.astype(np.int64) @ codes[slots].astype(np.int64).T
        m = np.broadcast_to(mult.astype(np.float64).reshape(-1, 1), (len(qc), 1))
        return m * raw + qoff[:, None] + voff[slots][None, :]
    if kind == "bq":
        bits = _unpack_bits(np.asarray(inner[0])[:, slots])  # [S, W*32]
        if len(eq) == 3:  # residual: asymmetric affine query
            qs, mult, qb = (np.asarray(a, np.float64) for a in eq)
            acc = qs @ bits[:, : qs.shape[1]].astype(np.float64).T
            return mult.reshape(-1, 1) * acc + qb.reshape(-1, 1)
        qbits = _unpack_bits(np.asarray(eq[0]).T)  # [Q, W*32]
        x = (qbits[:, None, :] != bits[None, :, :]).sum(axis=2).astype(np.float64)
        if dt == DistanceType.DOT:
            return 2 * x - dim if invert else dim - 2 * x
        return dim - 2 * x if invert else 2 * x - dim
    lut = np.asarray(eq[0], np.float64)  # [Q, m, K]
    codes = np.asarray(inner[0])[slots][:, : lut.shape[1]].astype(np.int64)
    out = lut[:, np.arange(lut.shape[1])[None, :], codes].sum(axis=2)
    if len(inner) > 1:
        out = out + np.asarray(inner[1], np.float64)[slots][None, :]
    return out


def reference_topk(kind, queries, eq, inner, slot_ids, buckets, s, k, *,
                   dim, dt, invert, means=None, corr_scale=None):
    """(scores [Q, k], score of each id {id: [Q]}) of a dense scan over
    ``buckets``: each slot scored, the residual bucket term added when
    ``corr_scale`` is given, pad slots (id -1) dropped, each id keeping its
    best slot."""
    slots = (np.asarray(buckets)[:, None] * s + np.arange(s)[None, :]).reshape(-1)
    sc = slot_scores(kind, eq, inner, slots, dim=dim, dt=dt, invert=invert)
    q = np.asarray(queries, np.float64)
    if corr_scale is not None:
        mb = np.asarray(means, np.float64)[slots // s]  # [S, D]
        sc = sc + float(corr_scale) * (q @ mb.T)
        _, rc = _residual_coeffs(dt, invert)
        if kind == "pq" and rc:
            sc = sc + rc * np.sum(q * q, axis=1)[:, None]
    ids = np.asarray(slot_ids).reshape(-1)[slots]
    uniq = np.unique(ids[ids >= 0])
    best = np.full((len(q), len(uniq)), -np.inf)
    col = np.searchsorted(uniq, ids)
    for j in np.flatnonzero(ids >= 0):
        best[:, col[j]] = np.maximum(best[:, col[j]], sc[:, j])
    best[best < NEG / 2] = -np.inf  # masked pad slots carry NEG additives
    order = np.argsort(-best, axis=1, kind="stable")[:, :k]
    top = np.take_along_axis(best, order, axis=1)
    return top, dict(zip(uniq.tolist(), best.T))


def assert_matches_reference(sv, ids, top, by_id, *, rtol=1e-5, atol=1e-4):
    """The engine's scores equal the reference top-k, and each returned id
    carries its own reference score (ids may swap only among ties)."""
    sv, ids = np.asarray(sv), np.asarray(ids)
    scale = max(1.0, float(np.max(np.abs(top[np.isfinite(top)]), initial=0.0)))
    fin = np.isfinite(top)
    np.testing.assert_allclose(sv[fin], top[fin], rtol=rtol, atol=atol * scale)
    for r in range(len(ids)):
        row = ids[r][ids[r] >= 0]
        assert len(set(row.tolist())) == len(row), "duplicate ids"
        got = np.array([by_id[int(i)][r] for i in row])
        np.testing.assert_allclose(
            got, sv[r][: len(row)], rtol=rtol, atol=atol * scale
        )
