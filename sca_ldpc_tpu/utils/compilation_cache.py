"""Persistent XLA compilation cache.

Attack decodes, FER sweeps and benchmarks reuse a small set of compile
shapes across process invocations, so every run after the first one in a
checkout starts warm.

Called from the CLI, the sweep driver, bench.py and chip_smoke.py — not on
package import, so library users keep full control of global JAX config.

Location: ``$JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it itself,
and nothing here overrides it); otherwise the fixed directory ``.jax_cache``
at the root of the checkout.  The path is part of what a later run must find
again, so it never depends on ``HOME`` or the working directory.
"""

import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def compilation_cache_dir():
    """The directory :func:`enable_persistent_compilation_cache` uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def enable_persistent_compilation_cache(min_compile_secs=1.0):
    """Turn on JAX's persistent compilation cache; returns its directory.

    Call before the first compile: JAX opens the cache once per process.
    """
    import jax

    cache_dir = compilation_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", float(min_compile_secs))
    return cache_dir
