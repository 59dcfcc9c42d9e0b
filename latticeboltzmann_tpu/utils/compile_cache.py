"""Where the entry points keep JAX's persistent compilation cache.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
here overrides it. Otherwise the cache lives at the fixed path
`<repo>/.jax_cache` (gitignored): the path is part of the cache key, so
a directory that moved between runs would never hit.
"""

from __future__ import annotations

import os
import pathlib

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir(environ=None) -> str:
    """The cache directory in effect for `environ` (default os.environ)."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV_VAR) or str(DEFAULT_DIR)


def enable(environ=None) -> str:
    """Point JAX at the cache directory unless the variable already
    does; returns the directory in effect."""
    environ = os.environ if environ is None else environ
    path = cache_dir(environ)
    if not environ.get(ENV_VAR):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
