"""Persistent compilation cache for the entry points.

Every command-line entry point (``tools/*``, ``bench.py``, ``chip_smoke.py``)
calls ``enable_compile_cache()`` before its first compilation, so a second
run of the same program loads the compiled step instead of recompiling it.
Importing the package sets nothing.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
sets nothing else.  Otherwise the cache lives at ``<checkout>/.jax_cache``,
a fixed path with no temporary name, process id or time in it, so that the
next run looks in the same place.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
