"""Test harness configuration.

Forces JAX onto an 8-device virtual CPU platform so sharding tests exercise a
real multi-device mesh without accelerators (the JAX analogue of the fake
clusters the reference lacks — SURVEY.md §4). Must run before any backend
initialization, so the platform is switched via jax.config before first
device use; the environment variables cover subprocesses too.

Tests that need a GPU carry the ``gpu`` marker and request the ``gpu``
fixture, which skips them unless JAX's default device is a GPU. The CPU
pin applies unless ``JAX_PLATFORMS`` names another platform, so on a GPU
machine ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` runs them.
"""

import os

ON_CPU = (os.environ.get("JAX_PLATFORMS") or "cpu") == "cpu"
if ON_CPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["JAX_NUM_CPU_DEVICES"] = "8"

import jax

if ON_CPU:
    try:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)
    except Exception:
        pass  # backend already initialized

import numpy as np
import pytest


@pytest.fixture
def rng(request):
    # Deterministic PER TEST (seeded from the test's nodeid), not per
    # session: a shared session RNG makes every test's data depend on
    # which tests ran before it, so threshold assertions (overlap >=
    # 0.8, recall bounds) flake under -x / -k / reordering. With a
    # per-test seed each test sees identical data no matter what else
    # runs.
    import zlib

    seed = zlib.crc32(request.node.nodeid.encode())
    return np.random.default_rng(seed)


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided here, at test
    time — never at import or collection, so every worker collects the
    same tests)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev


def pytest_report_header(config):
    return f"jax devices: {jax.devices()}"
