"""One rule for the persistent compile cache (altro_tpu.compile_cache)."""

import os

import jax

from altro_tpu import compile_cache


def test_env_variable_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.compile_cache_dir() == str(tmp_path)


def test_default_is_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.compile_cache_dir()
    checkout = os.path.dirname(os.path.dirname(compile_cache.__file__))
    assert path == os.path.join(checkout, ".jax_cache")
    # the same path every time: no home dir, temp name, pid or time
    assert compile_cache.compile_cache_dir() == path
    assert os.path.expanduser("~") not in path or checkout.startswith(
        os.path.expanduser("~"))


def test_enable_points_jax_at_the_rule(monkeypatch, tmp_path):
    before = (jax.config.jax_compilation_cache_dir,
              jax.config.jax_persistent_cache_min_compile_time_secs)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert compile_cache.enable_compile_cache(2.0) == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        assert jax.config.jax_persistent_cache_min_compile_time_secs == 2.0
    finally:
        jax.config.update("jax_compilation_cache_dir", before[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          before[1])
