"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (the CLI, ``bench.py``,
``chip_smoke.py``): if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads
it itself and nothing else is configured here; otherwise the cache
lives in ``<checkout>/.jax_cache`` (listed in .gitignore), a fixed path
so that later runs from the same checkout hit it.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"


def default_dir() -> str:
    """``<checkout>/.jax_cache``: next to the ``tpufluids`` package."""
    pkg = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(os.path.dirname(pkg), ".jax_cache")


def enable() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax

    path = default_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
