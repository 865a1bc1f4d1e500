"""Where JAX keeps its persistent compilation cache.

Every entry point (the apps, bench.py, benchmarks/, chip_smoke.py, the test
suite) calls :func:`enable_compile_cache` before its first compile, so all of
them share one cache and a second run skips the compiles of the first.
"""
from __future__ import annotations

import os

import jax

# a fixed path: the cache directory is part of the cache key, so a
# directory that moves between runs never hits
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it by itself and
    nothing is changed here.  Otherwise the cache goes to
    ``<repo>/.jax_cache``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
