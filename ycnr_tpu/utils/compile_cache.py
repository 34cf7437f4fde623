"""The one place that sets JAX's persistent compilation cache.

``$JAX_COMPILATION_CACHE_DIR`` wins when it is set; otherwise the cache
lives at a fixed path inside the checkout (``<repo>/.jax_cache``, git-
ignored). The path is part of every entry's key, so it never depends on a
uid, a pid, the time or ``/tmp``.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache(platform: Optional[str] = None) -> Optional[str]:
    """Point JAX's persistent cache at ``cache_dir()``; returns the path.

    Skipped (returns None) when the run asked for the CPU
    (``utils.device.cpu_asked``): XLA:CPU executables reloaded from the
    cache are checked against the host's machine features and warn of
    mismatches. Decided without initialising a backend, so a later
    ``--platform`` still applies."""
    from ycnr_tpu.utils.device import cpu_asked

    if cpu_asked(platform, jax.config.jax_platforms):
        return None
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
