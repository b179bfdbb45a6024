"""ann_benchmark CLI smoke tests on the virtual CPU mesh, including the
--sharded path (the CLI twin of demos/src/ann_benchmark.rs:104-162)."""

import numpy as np


def _run(argv):
    from quantization_tpu.bench.ann_benchmark import main

    return main(argv)


def test_cli_u8_synthetic_acc():
    res = _run([
        "--dataset", "sift", "--method", "u8", "--test-acc",
        "--synthetic-count", "3000", "--query-batch", "64",
    ])
    assert len(res) == 1
    assert res[0]["same_10"] > 0.5  # SQ on synthetic clustered data


def test_cli_sharded_two_stage():
    res = _run([
        "--dataset", "sift", "--method", "bq-u8", "--sharded", "--test-acc",
        "--synthetic-count", "3000", "--query-batch", "64",
    ])
    assert len(res) == 1
    assert res[0]["same_10"] > 0.5
    assert np.isfinite(res[0]["avg_us"])


def test_cli_sharded_exact_rescorer():
    res = _run([
        "--dataset", "sift", "--method", "bq-exact", "--sharded",
        "--test-acc", "--synthetic-count", "3000", "--query-batch", "64",
    ])
    assert res[0]["same_10"] > 0.6


def test_cli_u8_f32_two_stage():
    """The round-3 serving headline as a first-class CLI method: SQ-approx
    coarse -> original-vector rescore (BASELINE.md round 3)."""
    res = _run([
        "--dataset", "sift", "--method", "u8-f32", "--test-acc",
        "--synthetic-count", "3000", "--query-batch", "64",
        "--oversampling", "4",
    ])
    assert res[0]["same_10"] > 0.8  # f32 rescore recovers coarse loss


def test_cli_pq_opq_rotation():
    """--opq trains the learned rotation on the PQ path (ops/opq.py)."""
    res = _run([
        "--dataset", "sift", "--method", "pq", "--opq", "--test-acc",
        "--synthetic-count", "2000", "--query-batch", "64",
        "--chunk-size", "4",
    ])
    assert res[0]["same_10"] > 0.3  # smoke: trains + searches end to end


def test_cli_ivf_sq():
    """IVF probe-limited search as a CLI method (models/ivf.py)."""
    res = _run([
        "--dataset", "sift", "--method", "ivf-sq", "--test-acc",
        "--synthetic-count", "3000", "--query-batch", "64",
        "--nlist", "16", "--bucket-size", "64", "--nprobe", "8",
    ])
    assert res[0]["same_10"] > 0.4  # probe-limited on clustered synthetic


def test_cli_ivf_pq_f32_two_stage():
    """IVF-PQ coarse -> f32 rescore: the compressed-serving ladder."""
    res = _run([
        "--dataset", "sift", "--method", "ivf-pq-f32", "--test-acc",
        "--synthetic-count", "3000", "--query-batch", "64",
        "--nlist", "16", "--bucket-size", "64", "--nprobe", "16",
        "--chunk-size", "2", "--oversampling", "8",
    ])
    assert res[0]["same_10"] > 0.6


def test_cli_ivf_residual():
    """--residual wires residual inner codes (v - bucket_center, the
    IVFADC recipe) through the ivf-* CLI methods; needs bucket-size to
    be a multiple of the kernels' correction block (512)."""
    res = _run([
        "--dataset", "sift", "--method", "ivf-sq", "--residual",
        "--test-acc", "--synthetic-count", "3000", "--query-batch", "64",
        "--nlist", "4", "--bucket-size", "512", "--nprobe", "4",
    ])
    assert res[0]["same_10"] > 0.4


def test_cli_ivf_residual_bq():
    """Residual-BQ (asymmetric 1-bit residual signs) through the CLI —
    DOT datasets only (lastfm-64-dot in the registry)."""
    res = _run([
        "--dataset", "lastfm-64-dot", "--method", "ivf-bq", "--residual",
        "--test-acc", "--synthetic-count", "3000", "--query-batch", "64",
        "--nlist", "4", "--bucket-size", "512", "--nprobe", "4",
    ])
    assert res[0]["same_10"] >= 0.0  # wires + runs; quality is data-bound


def test_cli_sharded_bench_search_path():
    """--bench on a sharded index (no dense score_batch) measures the
    search path instead of silently skipping."""
    res = _run([
        "--dataset", "sift", "--method", "u8", "--sharded", "--bench",
        "--synthetic-count", "3000", "--query-batch", "64", "--iters", "2",
    ])
    assert res[0]["qps"] > 0


def test_cli_ivf_sq_f32_sharded():
    """IVF-SQ coarse -> f32 rescore (the 10M serving headline,
    BASELINE.md) with --sharded wrapping the coarse stage in ShardedIVF
    and the rescorer in ShardedExactRescorer."""
    res = _run([
        "--dataset", "sift", "--method", "ivf-sq-f32", "--sharded",
        "--test-acc", "--synthetic-count", "3000", "--query-batch", "64",
        "--nlist", "16", "--bucket-size", "64", "--nprobe", "8",
        "--oversampling", "8",
    ])
    assert res[0]["same_10"] > 0.6


def test_cli_ivf_bq():
    """IVF over the 1-bit family."""
    res = _run([
        "--dataset", "sift", "--method", "ivf-bq", "--test-acc",
        "--synthetic-count", "3000", "--query-batch", "64",
        "--nlist", "16", "--bucket-size", "64", "--nprobe", "16",
    ])
    assert res[0]["same_10"] > 0.2  # 1-bit codes: rank-order only


def test_cli_recall_target_knob():
    """--recall-target is accepted with --topk-method approx: the run
    completes and reports sane recall with a low target."""
    res = _run([
        "--dataset", "sift", "--method", "u8", "--test-acc",
        "--synthetic-count", "3000", "--query-batch", "64",
        "--topk-method", "approx", "--recall-target", "0.8",
    ])
    assert res[0]["same_10"] > 0.4


def test_cli_auto_config():
    """--auto-config calibrates a serving plan to a target recall
    (policy.recommend) instead of hand-picked --nscan/--oversampling."""
    res = _run([
        "--dataset", "sift", "--method", "ivf-sq", "--test-acc",
        "--synthetic-count", "4000", "--query-batch", "32",
        "--auto-config", "0.85",
    ])
    assert res[0]["same_10"] > 0.7  # plan measured on a 32-query sample


def test_cli_ivf_default_geometry():
    """ivf-* with no --nlist/--bucket-size uses auto_geometry."""
    res = _run([
        "--dataset", "sift", "--method", "ivf-sq", "--test-acc",
        "--synthetic-count", "4000", "--query-batch", "32",
        "--nprobe", "8",
    ])
    assert res[0]["same_10"] > 0.3


def test_cli_recall_target_two_stage_and_sharded():
    """--recall-target must ride through the TwoStageIndex and sharded
    wrappers, not just the plain quantizers (r4 review finding: every
    two-stage / sharded method crashed with TypeError)."""
    res = _run([
        "--dataset", "sift", "--method", "u8-f32", "--test-acc",
        "--synthetic-count", "3000", "--query-batch", "64",
        "--oversampling", "4",
        "--topk-method", "approx", "--recall-target", "0.8",
    ])
    assert res[0]["same_10"] > 0.6
    res = _run([
        "--dataset", "sift", "--method", "u8", "--sharded", "--test-acc",
        "--synthetic-count", "3000", "--query-batch", "64",
        "--topk-method", "approx", "--recall-target", "0.8",
    ])
    assert res[0]["same_10"] > 0.4
