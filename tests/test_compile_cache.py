"""The persistent compilation cache helper shared by the entry points."""
import os

import jax
import pytest

from danet_tpu import compile_cache


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_cache_dir_from_environment(monkeypatch, restore_cache_config,
                                    tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is the cache
    and the helper sets no other in code."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0


def test_cache_dir_default_is_fixed_inside_checkout(monkeypatch,
                                                    restore_cache_config):
    """Without the variable the cache lives at one fixed path inside the
    checkout, so a second run finds the first one's programs, and
    .gitignore keeps it out of commits."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert compile_cache.enable_compile_cache() == want
    assert compile_cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
