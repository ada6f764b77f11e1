"""Persistent XLA compilation cache.

The reference has no compilation step at all; here every sweep variant
costs a fresh XLA compile unless cached. Enabling the JAX persistent cache
makes repeat invocations — across processes — pay only the steady-state
run time.
"""
from __future__ import annotations

import os
from pathlib import Path

REPO_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_persistent_cache() -> Path:
    """Turn on JAX's persistent compilation cache; returns its directory.

    When `JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and this
    sets no directory in code: the cache goes there and nowhere else.
    Otherwise the cache is the fixed `<repo>/.jax_cache` (a fixed path, so
    later processes hit it). Must be called before the first compilation;
    safe to call more than once."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        path = Path(env)
    else:
        path = REPO_CACHE
        jax.config.update("jax_compilation_cache_dir", str(path))
    path.mkdir(parents=True, exist_ok=True)
    # cache every entry, no matter how small/fast
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
