"""The device lane's persistent compilation cache directory rule."""

import os

import pytest

from openvvc_tpu import decoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env", ["set", "unset"])
def test_compile_cache_dir(env, monkeypatch, tmp_path):
    import jax

    if env == "set":
        want = str(tmp_path / "cache")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO, ".jax_cache")
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    assert decoder.compile_cache_dir() == want
    prev = jax.config.jax_compilation_cache_dir
    try:
        decoder.Decoder(use_tpu=True)
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
