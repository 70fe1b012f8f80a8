"""Where the persistent JAX compilation cache lives — one helper owns it.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it and nothing here sets
another path.  Otherwise the cache lives in one fixed directory inside
the checkout, `.jax_cache/` (listed in .gitignore): the path is part of
the cache's key, so a fixed path is what lets one process reuse the
programs another compiled.  Call enable_compilation_cache() from every
entry point before the first jit execution.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the compilation cache uses."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable_compilation_cache() -> str:
    """Turn the persistent cache on; returns its directory.  Every
    program is cached, however fast it compiled: a run meets each new
    shape bucket mid-stream, where even a one-second compile stalls the
    chunk pipeline."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return path
