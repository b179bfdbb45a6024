"""chip_smoke.py's phases at a tiny size on the CPU: each phase's checks
pass on correct code, and the script refuses to report without a GPU."""

import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

N, DIM, Q, K = 4096, 64, 32, 10


@pytest.fixture(scope="module")
def corpus():
    data, queries = cs.make_corpus(N, DIM, 2 * Q, seed=3)
    return data, queries, cs.oracle_ids(queries, data, K)


def _run(args, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def _printed_result(stdout: str) -> bool:
    return any(line.startswith('{"ok"') for line in stdout.splitlines())


def test_make_corpus_is_seeded_and_normalized():
    a, qa = cs.make_corpus(256, DIM, 8, seed=1)
    b, qb = cs.make_corpus(256, DIM, 8, seed=1)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(qa, qb)
    np.testing.assert_allclose(np.linalg.norm(a, axis=1), 1.0, rtol=1e-5)
    assert a.shape == (256, DIM) and qa.shape == (8, DIM)


def test_device_phase_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        cs.phase_device()


def test_script_exits_nonzero_without_gpu():
    out = _run([str(ROOT / "chip_smoke.py")], cwd=ROOT)
    assert out.returncode != 0
    assert not _printed_result(out.stdout)
    assert "no GPU" in out.stderr


def test_script_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(["chip_smoke.py"], cwd=tmp_path)
    assert out.returncode != 0
    assert not _printed_result(out.stdout)


def test_phase_sq_two_stage(corpus):
    data, queries, gt = corpus
    out = cs.phase_sq_two_stage(data, queries, gt, q=Q, k=K)
    assert out["recall"] >= cs.MIN_RECALL_TWO_STAGE


def test_phase_sq_exact():
    out = cs.phase_sq_exact(nq=8, rows=256, dim=1536, seed=0)
    assert out["int_dot_exact"]


def test_phase_sq_score(corpus):
    from quantization_tpu import DistanceType, ScalarQuantizerU8, VectorParameters

    data, queries, _ = corpus
    sq = ScalarQuantizerU8.encode(
        data, VectorParameters(DIM, N, DistanceType.DOT, False), quantile=0.99
    )
    assert cs.phase_sq_score(sq, queries, data, rows=1024) <= DIM * 0.1


def test_phase_bq(corpus):
    data, queries, gt = corpus
    out = cs.phase_bq(data, queries, gt, k=K, sample=512)
    assert 0.0 <= out["recall"] <= 1.0


def test_phase_pq(corpus):
    data, queries, gt = corpus
    out = cs.phase_pq(data, queries, gt, k=K, chunk=8, sample=256)
    assert 0.0 <= out["recall"] <= 1.0


def test_phase_ivf(corpus):
    data, queries, gt = corpus
    out = cs.phase_ivf(data, queries, gt, k=K)
    assert out["recall"] >= cs.MIN_RECALL_IVF


def test_phase_select():
    out = cs.phase_select(2048, 8, pools=(10, 40))
    assert set(out) == {10, 40}


def test_phase_four():
    # Four of the harness's eight virtual CPU devices.
    out = cs.phase_four(N, DIM, q=Q, k=K, batches=2, seed=5)
    assert set(out["recall"]) == {"sq", "ivf", "bq_sq"}
