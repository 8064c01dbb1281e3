"""Persistent XLA compilation cache location.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is set, nothing here
overrides it. Otherwise the cache lives at one fixed directory inside the
checkout (``<repo>/.jax_cache``, listed in ``.gitignore``): the path is part
of the cache key, so it must not depend on a temp name, a pid or the time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_REPO, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory. Call before the first compilation."""
    import jax

    path = os.environ.get(ENV_VAR)
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    return path
