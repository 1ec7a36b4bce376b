"""Persistent XLA compilation cache setup.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no other directory.  Otherwise the cache lives at a fixed path
inside the checkout (``.jax_cache/``): the path is part of what makes a
cache hit, so it must not move between runs.  Called once, when the package
is imported; idempotent.
"""

from __future__ import annotations

import os
import pathlib

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"
_enabled = False


def enable_compilation_cache() -> None:
    global _enabled
    if _enabled:
        return
    _enabled = True
    if os.environ.get(ENV_VAR):
        return
    import jax

    DEFAULT_DIR.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
