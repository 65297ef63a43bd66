"""Small helpers shared by the package and its entry scripts."""

from __future__ import annotations

import os
from pathlib import Path


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    For entry scripts (benchmarks, examples, ``chip_smoke.py``); the
    library never calls it on import. Where ``JAX_COMPILATION_CACHE_DIR``
    is set, JAX reads it itself and no directory is set here. Otherwise
    the cache lives at the fixed ``<checkout>/.jax_cache``, so one
    checkout's runs find each other's programs.
    """
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = Path(__file__).resolve().parents[2] / ".jax_cache"
    path.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(path))
    return str(path)
