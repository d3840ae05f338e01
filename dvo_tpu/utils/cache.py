"""One place that decides where JAX keeps its persistent compile cache.

The chunked scan programs take tens of seconds to compile; a persistent
cache makes a repeat run start in seconds.  The cache key includes the
directory, so the directory must not move between runs: never a temporary
path, a process id or a time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# <checkout>/.jax_cache — listed in .gitignore.
DEFAULT_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), os.pardir, os.pardir, ".jax_cache")
)


def setup_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory and return it.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here.  Otherwise the cache goes to ``<checkout>/.jax_cache``.
    Call before the first compilation."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return DEFAULT_DIR
