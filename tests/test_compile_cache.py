"""Placement of JAX's persistent compilation cache (utils.compile_cache)."""

import os

import jax

from hessgpu_tpu.utils import compile_cache


def _restore(old):
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_var_wins_and_nothing_is_set(monkeypatch, tmp_path):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == old
    finally:
        _restore(old)


def test_default_is_fixed_dir_in_checkout(monkeypatch):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = compile_cache.enable_compile_cache()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        # the same path every time: it is part of the cache's key
        assert compile_cache.enable_compile_cache() == path
    finally:
        _restore(old)
