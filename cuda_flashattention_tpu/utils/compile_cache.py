"""JAX's persistent compilation cache, in one place.

If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing is
set here. Otherwise the cache goes to `<checkout>/.jax_cache` (listed in
.gitignore): a fixed path, because the path is part of the cache key and
a directory that moves never hits.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENV = "JAX_COMPILATION_CACHE_DIR"


def cache_dir(environ: Optional[Mapping[str, str]] = None) -> str:
    """Where compiled programs are cached under the rule above."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV) or os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Apply the rule; returns the directory in use."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
