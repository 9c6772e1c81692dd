"""Persistent XLA compilation cache setup.

The larger codec graphs take seconds to compile; caching them on disk
lets every process after the first skip the compile. Call ``enable()``
before the first jit execution (idempotent).

Where ``JAX_COMPILATION_CACHE_DIR`` is set, the cache lives there and
nowhere else; otherwise it lives at the fixed ``<checkout>/.jax_cache``
(the path is part of the cache key, so it must not move).
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parent.parent.parent / ".jax_cache"


def cache_dir(path: str | None = None) -> str:
    """The cache directory: the environment's, else ``path``, else the
    checkout's fixed default."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR") or path
            or str(DEFAULT_DIR))


def enable(path: str | None = None) -> str:
    """Point JAX's persistent compilation cache at ``cache_dir(path)`` and
    return that directory."""
    import jax

    d = cache_dir(path)
    Path(d).mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return d
