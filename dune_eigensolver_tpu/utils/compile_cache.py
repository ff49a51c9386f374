"""Persistent XLA compilation cache.

JAX's persistent compilation cache serializes compiled executables to disk
keyed on the program, so a second process running the same solve skips
compilation — the closest equivalent of the reference compiling once at
build time (CMake, SURVEY.md L7). It requires the jit discipline the
program caches already enforce (CLAUDE.md): operands as arguments, never
closure constants, which would change the key.

Where the cache lives:

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; this module sets
  no other directory.
* otherwise: ``<checkout>/.jax_cache`` (listed in .gitignore), a fixed path
  so that the next process finds what this one cached.

Enabled by default in the CLI (``ev.compile_cache=0`` opts out) and by
chip_smoke.py.
"""

from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the cache uses under the policy above."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Turn the persistent cache on (idempotent); returns its directory."""
    d = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    # compiles under a second are cheaper to redo than to load
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    # cache every sufficiently slow compile regardless of entry size
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return d
