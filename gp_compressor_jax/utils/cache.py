"""Persistent JAX compilation cache shared by tests, bench.py and
chip_smoke.py.

Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this module
points the cache nowhere else. Otherwise the cache lives in one fixed
directory inside the checkout, `<repo>/.jax_cache` (listed in .gitignore):
the directory is part of the cache's key, so it must not move between runs.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get(ENV_VAR) or REPO_CACHE_DIR


def setup_compilation_cache(min_compile_secs: float = 0.0) -> None:
    """Enable the persistent cache (see the module docstring)."""
    import jax

    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
