"""Persistent XLA compilation cache.

The engine's serving programs are compiled once per (shape, quantizer) and
reused; paying the XLA compile at every process start is waste. This turns
on JAX's persistent cache so a program compiles once per cache directory.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX
reads it itself, and no other directory is set here), otherwise the fixed
``<checkout>/.jax_cache`` (listed in ``.gitignore``). The path is part of
what makes a cache hit, so it never moves.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".jax_cache")

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def enable_compilation_cache() -> str:
    """Turn on the persistent compilation cache; return its directory.
    Idempotent. Call it before the first compile."""
    import jax

    path = os.environ.get(ENV_VAR)
    if not path:
        path = DEFAULT_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # Cache every program, however quick its compile: a search step is
    # many small programs whose compiles add up at start-up.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
