"""The persistent compile cache's directory: JAX_COMPILATION_CACHE_DIR
when it is set, otherwise <checkout>/.jax_cache."""

import jax
import pytest

from gnuais_tpu import compile_cache


@pytest.mark.parametrize("from_env", [False, True])
def test_compile_cache_dir(from_env, monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    if from_env:
        want = str(tmp_path / "cache")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert (compile_cache.CHECKOUT / "gnuais_tpu").is_dir()
        want = str(compile_cache.CHECKOUT / ".jax_cache")
    try:
        assert compile_cache.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
