"""Persistent XLA compile cache: the one place the program chooses it.

Where `JAX_COMPILATION_CACHE_DIR` is set, that directory is used as given.
Otherwise the cache lives at a fixed `.jax_cache/` in the checkout (listed in
`.gitignore`): the path is part of the cache key, so it must not move
between runs. SLAMSystem calls `enable()` from its constructor, so every
entry point (CLI, tests, bench, tools) recompiles warm.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    """The directory `enable()` points JAX at."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_DIR)


def enable() -> str:
    """Point JAX at the persistent compilation cache; returns its path."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
