"""JAX's persistent compilation cache, placed from outside the code.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this module
sets nothing.  Otherwise the cache goes to a fixed `.jax_cache/` inside
the checkout (listed in .gitignore): the path is part of what the cache
is keyed on, so a directory that moved between runs would never hit.
"""
from __future__ import annotations

import os

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
