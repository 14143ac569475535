"""Persistent XLA compilation cache.

Compiling a per-topology pruning program takes seconds to minutes, so entry
points call ``enable_compile_cache()`` and a later process reuses what an
earlier one compiled. The cache directory's path is part of the cache key,
so it never moves: ``JAX_COMPILATION_CACHE_DIR`` where that is set (JAX
reads the variable itself, and nothing else is configured here), otherwise
``.jax_cache/`` at the root of the checkout.
"""
from __future__ import annotations

import os

import jax

__all__ = ["cache_dir", "enable_compile_cache"]

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CHECKOUT_CACHE = os.path.join(_CHECKOUT, ".jax_cache")


def cache_dir() -> str:
    """The directory the compilation cache uses: the environment
    variable's value where set, else the fixed in-checkout directory."""
    return os.environ.get(ENV_VAR) or CHECKOUT_CACHE


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``cache_dir()``.
    Returns the directory in use. Safe to call repeatedly."""
    path = cache_dir()
    if os.environ.get(ENV_VAR):
        return path
    if jax.config.jax_compilation_cache_dir != path:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
    return path
