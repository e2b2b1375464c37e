"""Shared runtime utilities (tracing, NaN debugging, logging)."""

from __future__ import annotations

import os

# the checkout's own cache directory (listed in .gitignore); a fixed path,
# because the cache key includes it and a moving directory never hits
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def compile_cache_dir() -> str:
    """Where the persistent compilation cache lives: the directory named
    by ``JAX_COMPILATION_CACHE_DIR`` when that is set (JAX reads it
    itself), else ``DEFAULT_CACHE_DIR`` inside the checkout."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache(min_compile_secs: float = 1.0) -> None:
    """Turn on JAX's persistent compilation cache.

    Reference-scale programs take tens of seconds to compile; the cache
    makes repeat invocations (resume, sample-after-train, benchmarks)
    start in about a second.  With ``JAX_COMPILATION_CACHE_DIR`` set,
    JAX already uses that directory and no other is set here.
    """
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
