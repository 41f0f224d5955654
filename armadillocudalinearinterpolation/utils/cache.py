"""Persistent XLA compilation cache.

A cold staged solve compiles several large programs; the persistent cache
makes that a one-time cost per machine instead of per process.  Wired into
the CLI driver, ``bench.py``, ``chip_smoke.py`` and the test conftest — call
:func:`enable_compilation_cache` before the first compilation (it is harmless
afterwards; already-compiled programs simply miss the cache).
"""

from __future__ import annotations

import os
import pathlib

import jax

_DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compilation_cache() -> str:
    """Point JAX at a persistent on-disk compilation cache.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    this function sets no other directory; otherwise the cache is the fixed
    path ``<repo>/.jax_cache`` (gitignored).

    Returns the directory in use.
    """
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = str(_DEFAULT_DIR)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    pathlib.Path(cache_dir).mkdir(parents=True, exist_ok=True)
    # Cache everything that took real compile time; tiny programs recompile
    # faster than they deserialise.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir
