"""Compile-cache directory rules (utils/cache.py)."""

import jax

from vkrt_jax.utils import cache


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the one directory used."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    old = jax.config.jax_compilation_cache_dir
    try:
        assert cache.enable_compilation_cache() == str(tmp_path / "c")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
        assert (tmp_path / "c").is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_cache_dir_default_in_checkout(monkeypatch):
    """Without the variable the cache is the fixed, gitignored
    <checkout>/.jax_cache."""
    import os

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.cache_dir() == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
