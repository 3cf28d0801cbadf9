"""JAX persistent compilation cache location, shared by every entry point.

When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here overrides it. Otherwise the cache goes to a fixed directory inside the
checkout (``<repo>/.jax_cache``, listed in ``.gitignore``): the path is part
of the cache's key, so it never depends on a process id or the time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``cache_dir()``."""
    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
