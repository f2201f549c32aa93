"""Where the persistent compilation cache lives.

``JAX_COMPILATION_CACHE_DIR`` wins when set (JAX reads it itself); otherwise
the cache is the fixed directory ``.jax_cache`` in the checkout.  See also
test_cli.py::test_persistent_compilation_cache_util.
"""

import os
import subprocess
import sys
import textwrap

import jax

from sca_ldpc_tpu.utils import compilation_cache
from sca_ldpc_tpu.utils.compilation_cache import (
    compilation_cache_dir,
    enable_persistent_compilation_cache,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_follows_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "outside"))
    assert compilation_cache_dir() == str(tmp_path / "outside")


def test_cache_dir_defaults_into_checkout(tmp_path, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compilation_cache_dir() == os.path.join(REPO, ".jax_cache")
    # enable it against a stand-in checkout, so this test writes nothing
    # into the real one
    fixed = str(tmp_path / "checkout" / ".jax_cache")
    monkeypatch.setattr(compilation_cache, "CHECKOUT_CACHE_DIR", fixed)
    prev = jax.config.jax_compilation_cache_dir
    try:
        assert enable_persistent_compilation_cache() == fixed
        assert jax.config.jax_compilation_cache_dir == fixed
        assert os.path.isdir(fixed)
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_compiles_are_written_only_where_the_environment_says(tmp_path):
    """A fresh process with JAX_COMPILATION_CACHE_DIR set writes its
    compiled programs there."""
    cache = tmp_path / "cache"
    code = textwrap.dedent("""
        import jax, jax.numpy as jnp
        from sca_ldpc_tpu.utils import enable_persistent_compilation_cache
        print(enable_persistent_compilation_cache(min_compile_secs=0))
        jax.jit(lambda x: jnp.cumsum(x * 3.0))(jnp.arange(97.0)).block_until_ready()
        print(jax.config.jax_compilation_cache_dir)
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(cache),
               PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, cwd=str(tmp_path), timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == [str(cache), str(cache)]
    assert any(cache.iterdir())
