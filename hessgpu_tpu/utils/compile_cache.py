"""Where JAX keeps its persistent compilation cache.

Entry points (the CLI, the feature server's backend, the bench scripts and
chip_smoke.py) call enable_compile_cache() before their first compile, so
a second process on the same checkout reuses what the first compiled.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing
    is changed here. Otherwise the cache goes to <checkout>/.jax_cache:
    a fixed path, because the path is part of what a later process must
    find again.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
