"""Placement of JAX's persistent compilation cache.

A fresh process that finds its programs in the cache skips XLA
compilation. The cache key includes the directory, so it lives at a fixed
path: `JAX_COMPILATION_CACHE_DIR` when set (JAX reads it itself, and
nothing is set in code), otherwise `.jax_cache` at the root of the
checkout.
"""

from __future__ import annotations

import os

import jax

CHECKOUT_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT_DIR, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    # Cache every program: the match pipeline's small stage programs are
    # cheap to compile one by one but many in number.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return DEFAULT_CACHE_DIR
