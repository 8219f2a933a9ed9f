"""Placement of the persistent compile cache (utils/compile_cache.py):
JAX_COMPILATION_CACHE_DIR wins and nothing is set in code; otherwise the
cache is <checkout>/.jax_cache."""

import os

import jax

from fastest_image_pattern_matching_tpu.utils import compile_cache


def test_env_dir_is_used_and_nothing_set(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_default_dir_is_in_the_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert ("jax_compilation_cache_dir", path) in calls
