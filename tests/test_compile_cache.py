"""utils/compile_cache.py: the persistent cache goes where
JAX_COMPILATION_CACHE_DIR says when it is set, and to the fixed
``<checkout>/.jax_cache`` otherwise. Each case runs in a fresh process,
since the cache settings are process-global."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = """
import jax, jax.numpy as jnp
from quantization_tpu.utils.compile_cache import enable_compilation_cache
path = enable_compilation_cache()
jax.jit(lambda x: x * 3 + 1)(jnp.arange(7.0)).block_until_ready()
print(path)
print(jax.config.jax_compilation_cache_dir)
"""


def _probe(env_extra, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT), **env_extra)
    out = subprocess.run(
        [sys.executable, "-c", PROBE], env=env, capture_output=True,
        text=True, timeout=120, check=True,
    )
    return out.stdout.split()[-2:]


def test_compile_cache_honours_env_var(tmp_path):
    target = tmp_path / "cache"
    path, configured = _probe({"JAX_COMPILATION_CACHE_DIR": str(target)})
    assert path == configured == str(target)
    assert any(target.iterdir()), "nothing was cached in the env var's dir"


def test_compile_cache_fixed_default():
    from quantization_tpu.utils import compile_cache

    path, configured = _probe({}, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert path == configured == compile_cache.DEFAULT_DIR
    assert Path(path) == ROOT / ".jax_cache"
