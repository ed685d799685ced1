"""JAX's persistent compilation cache, in one place for every entry point.

A later run finds what an earlier one compiled only if both use the same
directory, so the directory is fixed: ``JAX_COMPILATION_CACHE_DIR`` when
the environment sets it (JAX reads that variable itself), otherwise
``.jax_cache`` at the root of the checkout.
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory.  Call before the first compilation."""
    import jax

    path = os.environ.get(ENV_VAR)
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    # cache every program, not only those that took a second to compile:
    # a cold run of the CLI compiles many small ones
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return path
