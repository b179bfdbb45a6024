"""Serving auto-configuration: the recall frontier as an API.

Earlier rounds measured recall@10 for ~40 serving configurations on
seeded corpora (up to 10M x 768), across six method families x {nscan,
rescore depth, bucket geometry, residual}. The recall figures below are
those measurements; recall depends on the data and the codes, not on the
device. This module encodes the rules they gave:

* ``recommend(index, target_recall, ...)`` — a :class:`ServingPlan`
  seeded from the recall tables below, with
  an optional CALIBRATION sweep that walks the plan's knobs on a query
  sample against an exact f32 oracle until the target recall is met.
  Static rules get within the right regime; only a measurement can land
  within +-0.02 of a target on YOUR data, so calibration is the primary
  path and the tables are its starting point.
* ``ServingPlan.build(index, data)`` — turn the plan into a searchable
  object: a ``_MethodPinned`` wrapper (or a ``TwoStageIndex`` over one)
  that pins method/scan/nscan in the returned object only — the index
  and its metadata are never mutated.
* ``exact_topk(queries, data, ...)`` — the blocked f32 oracle
  (device-resident, O(Q x block) memory — the reference's bounded-heap
  GT pattern, ann_benchmark_data.rs:151-166).

Rules encoded here (recall@10 measured on seeded corpora):

1. Full-scan SQ coarse saturates ~0.88 on realistic data; the SQ->f32
   two-stage at ov=4 reaches 0.983.
2. BQ coarse is distribution-bound (0.336 realistic); serving BQ means
   BQ->f32 at ov 16-32 (ov=64 buys 0.979).
3. PQ/OPQ full-scan is a coarse/compression code — recommend routes
   PQ targets above its measured ceiling to a rescored plan.
4. IVF coarse recall is a function of the SCANNED FRACTION and the
   query-batch diversity (the batch-union needs every query's
   clusters). Coarse saturates (0.868 for SQ at f=0.24) and the f32
   rescore recovers the rest (0.979 at R=4k).
5. Geometry: nlist * bucket_size ~ N/3 or less, bucket_size the widest
   tile the family's indexed kernel rides (1024; 2048 pads too much at
   default nlist) — "Bucket-size leg" and the padding rule.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .core.distances import pairwise_score
from .core.types import ArgumentsError, DistanceType
from .models.pipeline import ExactRescorer, TwoStageIndex
from .ops.topk import blocked_topk


def exact_topk(queries, data, distance_type, invert, k, block_rows=1 << 18):
    """(scores, ids) of the exact f32 top-k, blocked on device."""
    q = jnp.asarray(queries, jnp.float32)

    def score_block(b0, b1):
        # jnp.asarray: a device-resident corpus slices on device; a host
        # array/memmap uploads one block. Never np.asarray(data) — that
        # would pull the WHOLE corpus to the host just to score a block.
        return pairwise_score(
            q, jnp.asarray(data[b0:b1], jnp.float32), distance_type, invert
        )

    n = data.shape[0] if hasattr(data, "shape") else len(data)
    return blocked_topk(score_block, int(n), k, block_rows=block_rows)


def recall_at_k(ids, gt_ids) -> float:
    ids, gt_ids = np.asarray(ids), np.asarray(gt_ids)
    k = gt_ids.shape[1]
    return float(np.mean([
        len(set(ids[r].tolist()) & set(gt_ids[r].tolist())) / k
        for r in range(gt_ids.shape[0])
    ]))


@dataclass
class ServingPlan:
    """One point on the serving frontier, buildable and replayable.

    ``oversampling`` <= 1 means coarse-only (no rescore stage);
    ``nscan`` is the IVF scanned-bucket budget (None for full-scan
    indexes). ``expected_recall`` is the measured recall when the plan
    came out of a calibration sweep, else the table estimate."""

    method: str = "approx"
    scan: str = "auto"
    nscan: Optional[int] = None
    oversampling: float = 1.0
    expected_recall: Optional[float] = None
    calibrated: bool = False
    notes: str = ""
    history: list = field(default_factory=list)  # (knobs, recall) pairs

    def build(self, index, data=None, *, rescorer=None, k: int = 10):
        """A searchable object implementing encode_query/top_k.

        ``data`` (the original f32 vectors — array or np.memmap) backs
        the f32 rescore stage when the plan has one; pass ``rescorer``
        to reuse an existing (possibly sharded) rescorer instead.

        The plan's knobs are pinned in the RETURNED object only — the
        index itself is never mutated (so calibration trials, and plans
        the caller discards, leave ``index.metadata`` untouched)."""
        if self.nscan is not None and not _is_ivf(index):
            raise ArgumentsError("nscan plan needs an IVF index")
        pinned = _MethodPinned(index, self.method, self.scan, self.nscan)
        if self.oversampling <= 1.0:
            return pinned
        if rescorer is None:
            if data is None:
                raise ArgumentsError(
                    "a rescored plan needs `data` (original vectors) or "
                    "an explicit `rescorer`"
                )
            p = index.params if hasattr(index, "params") else index.metadata.vector_parameters
            rescorer = _make_rescorer(index, data, p.distance_type, p.invert)
        return TwoStageIndex(
            pinned, rescorer, oversampling=self.oversampling,
            coarse_method=self.method,
        )

    def serve(
        self, index, data=None, *, rescorer=None, k: int = 10,
        depth: int = 8,
    ):
        """``build`` wrapped in a :class:`~quantization_tpu.serving.
        PipelinedSearcher` — the deployment-shaped serving loop (keeps
        ``depth`` searches in flight; see serving.py for the measured
        blocking-wrapper trap it avoids)."""
        from .serving import PipelinedSearcher

        return PipelinedSearcher(
            self.build(index, data, rescorer=rescorer, k=k),
            k=k, depth=depth,
        )


def _make_rescorer(index, data, dt, invert):
    """f32 rescorer matched to the index's engine: an index that carries
    a device mesh (ShardedIVF, the sharded quantizers) gets a
    ``ShardedExactRescorer`` over the SAME mesh/axis — a rescored plan
    must never funnel the whole f32 corpus through one chip's HBM when
    the coarse stage is already sharded. Single-device indexes get the
    plain ``ExactRescorer`` (host-resident for memmap corpora)."""
    mesh = getattr(index, "mesh", None)
    if mesh is not None:
        from .parallel.sharded import ShardedExactRescorer

        return ShardedExactRescorer(
            data, dt, invert,
            mesh=mesh, axis=getattr(index, "axis", "shard"),
        )
    return ExactRescorer(
        data, dt, invert, host_resident=bool(isinstance(data, np.memmap))
    )


def _is_ivf(index) -> bool:
    """Only the IVF families take scan=/nscan= knobs; every full-scan
    quantizer also has ``.metadata``, so test for the IVF-only field."""
    return hasattr(getattr(index, "metadata", None), "nbuckets")


class _MethodPinned:
    """Coarse-only searchable: pins the plan's method/scan/nscan knobs so
    ``top_k(eq, k)`` replays the plan with no extra arguments. Also
    serves as the coarse stage of a rescored plan's ``TwoStageIndex``
    (forwarding ``count``/``top_k_device``), which is how a plan pins
    nscan without mutating the index's metadata."""

    def __init__(self, index, method, scan, nscan=None):
        self._ix, self._method, self._scan = index, method, scan
        self._nscan = nscan

    @property
    def count(self):
        return self._ix.count

    def encode_query(self, queries):
        return self._ix.encode_query(queries)

    def _pin(self, kw):
        kw.setdefault("method", self._method)
        if _is_ivf(self._ix):  # IVF families take scan=/nscan=
            kw.setdefault("scan", self._scan)
            if self._nscan is not None:
                kw.setdefault("nscan", int(self._nscan))
        return kw

    def top_k(self, eq, k, **kw):
        return self._ix.top_k(eq, k, **self._pin(kw))

    def top_k_device(self, eq, k, **kw):
        # TwoStageIndex passes recall_target=None through; drop the
        # no-op so full-scan top_k_device defaults stay in charge.
        if kw.get("recall_target", 0) is None:
            del kw["recall_target"]
        return self._ix.top_k_device(eq, k, **self._pin(kw))


# IVF-SQ coarse recall@10 vs scanned fraction at Q=256, measured on a
# seeded 10M x 768 realistic corpus. Seeds the sweep's first probe;
# calibration owns the final word.
_IVF_FRACTION_CURVE = [
    (0.012, 0.162), (0.049, 0.525), (0.122, 0.814), (0.244, 0.868),
]
# Coarse saturation per family (realistic anchor): above this, add the
# f32 rescore rather than more scanning.
_COARSE_CEILING = {"sq": 0.86, "bq": 0.33, "pq": 0.18}


# Batch-diversity exponent: the union fraction scales SUBlinearly in Q
# (query probe sets overlap). Two measured recall anchors: Q=32 needed
# ~1/5 the fraction of Q=256 at equal recall, so f ~ Q^a with
# a = ln(5)/ln(8) ~ 0.774 (linear-in-Q would predict 1/8 — it
# over-shrinks small batches and the calibration sweep then climbs
# several rungs).
_Q_DIVERSITY_EXP = 0.774
# Uncalibrated floor: Q=1 measured full coarse recall at nscan=64 of
# 21.6k buckets (~0.3%); never seed below 1%.
_SEED_FRACTION_FLOOR = 0.01


def _seed_fraction(target: float, q_batch: int) -> float:
    """Scanned fraction whose MEASURED Q=256 coarse recall first meets
    ``target``, scaled by batch diversity (the union must cover every
    query's clusters; see ``_Q_DIVERSITY_EXP``).

    Uncalibrated-error bound (pinned by test_policy): between the
    measured anchors (Q in [1, 1024], targets within the table's recall
    span) the seed lands within TWO calibration rungs (nscan doublings)
    of the calibrated plan — the curve picks the regime, calibration
    owns the final word. Outside the span (targets above the coarse
    ceiling) the seed intentionally saturates at the table's last row
    and the rescore stage, not more scanning, closes the gap."""
    f = _IVF_FRACTION_CURVE[-1][0]
    for fi, r in _IVF_FRACTION_CURVE:
        if r >= target:
            f = fi
            break
    scale = (max(q_batch, 1) / 256.0) ** _Q_DIVERSITY_EXP
    return min(1.0, f * scale + _SEED_FRACTION_FLOOR)


def recommend(
    index,
    target_recall: float,
    *,
    k: int = 10,
    q_batch: int = 256,
    queries=None,
    data=None,
    tolerance: float = 0.02,
    max_evals: int = 12,
) -> ServingPlan:
    """A serving plan meeting ``target_recall`` at minimal scan cost.

    With ``queries`` + ``data``: runs the calibration sweep — walk the
    knob ladder (IVF: nscan doubling until coarse saturates, then
    rescore depth doubling; full-scan: rescore depth) measuring
    recall@k on the sample against the exact f32 oracle, and return the
    first (cheapest) configuration whose measured recall >=
    ``target_recall - tolerance``. Without them: the static
    table-seeded plan (right regime, no +-0.02 guarantee).

    ``index`` is a built quantizer (SQ/BQ/PQ) or IVF index (single or
    sharded). The returned plan's ``build(index, data)`` yields the
    serving object."""
    if not (0.0 < target_recall <= 1.0):
        raise ArgumentsError("target_recall must be in (0, 1]")
    is_ivf = _is_ivf(index)
    kind = index.metadata.kind if is_ivf else _family_of(index)
    ceiling = _COARSE_CEILING.get(kind, 0.8)

    plan = ServingPlan()
    if is_ivf:
        nb = index.metadata.nbuckets
        f = _seed_fraction(min(target_recall, ceiling), q_batch)
        # Per-query floor: each query's top-k lives in its nearest
        # k-means cell(s), whose rows span ~nb/nlist buckets — a union
        # below q_batch * that depth starves some query of its own cell
        # (the batch-union is rank-fair but width-limited). The fraction
        # curve owns large-Q geometries (unions overlap); this floor
        # owns small Q and small bucket counts. Both are seeds —
        # calibration owns the final word (bound: <= 2 rungs, pinned by
        # test_policy).
        depth = max(1, -(-nb // max(index.metadata.nlist, 1)))
        plan.nscan = max(
            1, min(nb, max(int(round(f * nb)), min(nb, q_batch * depth)))
        )
        if target_recall > ceiling - 0.05:
            plan.oversampling = 4.0
        plan.notes = (
            f"seeded from the IVF recall table (f={f:.3f} of {nb} buckets)"
        )
    else:
        if kind == "sq":
            plan.oversampling = 1.0 if target_recall <= 0.85 else 4.0
        elif kind == "bq":
            plan.oversampling = max(4.0, 16.0 * target_recall)
        else:  # pq family: coarse/compression code — always rescore
            plan.oversampling = 16.0
        plan.notes = "seeded from the full-scan recall table"
        plan.expected_recall = None

    if queries is None or data is None:
        return plan

    # ---- calibration sweep -------------------------------------------
    p = index.params if hasattr(index, "params") else None
    dt = p.distance_type if p else DistanceType.DOT
    invert = p.invert if p else False
    _, gt = exact_topk(queries, data, dt, invert, k)
    gt = np.asarray(gt)
    eq = index.encode_query(queries)
    rescorer = _make_rescorer(index, data, dt, invert)

    def measure(nscan, ov):
        trial = ServingPlan(
            method=plan.method, scan=plan.scan, nscan=nscan,
            oversampling=ov,
        )
        obj = trial.build(index, data, rescorer=rescorer, k=k)
        teq = eq if ov <= 1.0 else obj.encode_query(queries)
        _, ids = obj.top_k(teq, k)
        r = recall_at_k(ids, gt)
        plan.history.append(
            ({"nscan": nscan, "oversampling": ov}, r)
        )
        return r

    bar = target_recall - tolerance
    evals = 0
    best = None
    nscan = plan.nscan
    ov = plan.oversampling if not is_ivf else 1.0
    prev = -1.0
    nb = index.metadata.nbuckets if is_ivf else None
    while evals < max_evals:
        r = measure(nscan, ov)
        evals += 1
        if r >= bar:
            best = (nscan, ov, r)
            break
        saturated = r - prev < 0.01 and prev >= 0.0
        prev = r
        if is_ivf and nscan < nb and not saturated:
            nscan = min(nb, nscan * 2)  # more scanning first
        elif ov <= 1.0:
            ov, prev = 4.0, -1.0  # add the f32 rescore stage
        elif ov < 64.0:
            ov *= 2.0  # deepen the rescore
        elif is_ivf and nscan < nb:
            nscan, prev = min(nb, nscan * 2), -1.0
        else:
            break  # ladder exhausted
    if best is None:
        # Target unreachable within the ladder: return the best measured
        # point, honestly labeled.
        knobs, r = max(plan.history, key=lambda h: h[1])
        plan.nscan, plan.oversampling = knobs["nscan"], knobs["oversampling"]
        plan.expected_recall = r
        plan.calibrated = True
        plan.notes += (
            f"; target {target_recall} unreachable on this ladder "
            f"(best measured {r:.3f})"
        )
        return plan
    plan.nscan, plan.oversampling, plan.expected_recall = best
    plan.calibrated = True
    plan.notes += f"; calibrated on {np.asarray(queries).shape[0]} queries"
    return plan


def _family_of(index) -> str:
    name = type(index).__name__.lower()
    for kind in ("sq", "scalarquantizer"), ("bq", "binary"), ("pq", "product"):
        if kind[1] in name or name.startswith(kind[0]):
            return kind[0]
    return "sq"
