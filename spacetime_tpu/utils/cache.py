"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (Engine, the CLI, bench.py, chip_smoke.py,
the tests and tools/): if JAX_COMPILATION_CACHE_DIR is set, JAX already
reads it and nothing here changes it; otherwise the cache lives in a fixed
`.jax_cache/` directory at the root of the checkout.  The path is part of
what makes a cache hit, so it must not move from one process to the next.
"""

from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> str:
    """Turn the persistent cache on and return its directory.  A directory
    already configured (by JAX_COMPILATION_CACHE_DIR or by the caller) is
    kept as it is."""
    current = jax.config.jax_compilation_cache_dir
    if current:
        return current
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
