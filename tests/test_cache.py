"""Compile-cache placement: ``JAX_COMPILATION_CACHE_DIR`` where set (and
nothing configured in code), else one fixed directory in the checkout."""
import os

import jax
import pytest

from phylo_utils_tpu.utils import cache

_KEYS = ("jax_compilation_cache_dir",
         "jax_persistent_cache_min_entry_size_bytes",
         "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture
def restore_config():
    old = {k: getattr(jax.config, k) for k in _KEYS}
    yield
    for k, v in old.items():
        jax.config.update(k, v)


def test_env_var_is_used_and_nothing_is_set(monkeypatch, tmp_path,
                                            restore_config):
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    before = {k: getattr(jax.config, k) for k in _KEYS}
    assert cache.enable_compile_cache() == str(tmp_path)
    assert {k: getattr(jax.config, k) for k in _KEYS} == before


def test_unset_env_uses_fixed_checkout_dir(monkeypatch, restore_config):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = cache.enable_compile_cache()
    assert path == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.isdir(path)


def test_repeated_calls_keep_one_directory(monkeypatch, restore_config):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    first = cache.enable_compile_cache()
    assert cache.enable_compile_cache() == first == cache.cache_dir()
    assert jax.config.jax_compilation_cache_dir == first
