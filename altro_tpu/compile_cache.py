"""Where JAX's persistent compilation cache lives.

One rule for every entry point (bench.py, chip_smoke.py,
scripts/bench_all.py, the test suite): `JAX_COMPILATION_CACHE_DIR` when
it is set, otherwise a fixed `.jax_cache/` inside the checkout. The path
is part of the cache key, so it is never made from the home directory, a
temporary name, a process id or the time.
"""

from __future__ import annotations

import os

__all__ = ["compile_cache_dir", "enable_compile_cache"]

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir() -> str:
    """The cache directory the rule above selects."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))


def enable_compile_cache(min_compile_time_secs: float = 1.0) -> str:
    """Point JAX's persistent cache at `compile_cache_dir()`; returns it.
    Call before the first compilation."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_time_secs)
    return path
