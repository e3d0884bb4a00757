"""The one place that chooses JAX's persistent compilation cache directory.

When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing.  Otherwise the cache lives at ``<repo>/.jax_cache``:
a fixed path inside the checkout, because the path is part of the cache
key and a directory that moves with the shell never hits.
"""
from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir() -> str:
    """The directory the persistent compile cache uses."""
    return os.environ.get(ENV_VAR) or str(DEFAULT_DIR)


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    if not os.environ.get(ENV_VAR):
        import jax

        jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return compile_cache_dir()
