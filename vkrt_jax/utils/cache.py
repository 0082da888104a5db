"""Persistent XLA compilation cache.

Compiling the frame and the LBVH build takes a noticeable share of a
short run; the persistent cache lets the bench, the CLI and
chip_smoke.py reuse compiled programs across processes. The directory is
the one `JAX_COMPILATION_CACHE_DIR` names when it is set, and otherwise
the fixed `<checkout>/.jax_cache` (gitignored). Call once before building or
tracing; safe to call more than once.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def cache_dir() -> str:
    """The directory compiled programs are cached in."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compilation_cache() -> str:
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
