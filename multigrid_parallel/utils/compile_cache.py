"""Where JAX keeps its persistent compilation cache.

A whole-solve driver compiles one large program per (grid, config), so a
warm cache saves most of a run's set-up. The cache is keyed by path, so
the directory must not move between runs: ``JAX_COMPILATION_CACHE_DIR``
when the environment sets it (JAX reads that variable itself), otherwise
``.jax_cache/`` at the root of the checkout.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX at the persistent compilation cache; returns its path.

    Sets nothing when ``JAX_COMPILATION_CACHE_DIR`` is set. Call before
    the first compilation.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)
