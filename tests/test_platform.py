"""Entry-point helpers: the persistent compilation cache location."""

import os
import tempfile

import jax
import pytest

from sparsex_jax import platform

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config(monkeypatch):
    """Restore JAX's cache setting after the test; start with no env."""
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_dir_is_used(cache_config, monkeypatch, tmp_path):
    """JAX reads JAX_COMPILATION_CACHE_DIR itself; the helper sets none."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert platform.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(cache_config):
    path = platform.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_path_is_fixed(cache_config):
    """No pid, tempdir or time in the path: a later run finds it."""
    first = platform.enable_compile_cache()
    assert platform.enable_compile_cache() == first
    assert str(os.getpid()) not in first
    assert not first.startswith(tempfile.gettempdir())
