"""Tracing / profiling hooks (SURVEY.md §5).

The reference logs epoch wall-clock to the console; the rebuild exposes
(a) `jax.profiler` traces viewable in TensorBoard/Perfetto and (b) a phase
timer that waits for the device (`jax.block_until_ready`) before reading
the clock.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import jax


@contextlib.contextmanager
def phase_timer(name: str, result_holder: Optional[dict] = None,
                sync_on=None, echo: bool = True):
    """Wall-clock a phase, waiting at exit for ``sync_on`` (arrays, or a
    callable returning them) to finish on the device.

    with phase_timer("u_phase", stats, sync_on=lambda: state.U):
        state = u_phase(state, ...)
    """
    t0 = time.time()
    yield
    if sync_on is not None:
        jax.block_until_ready(sync_on() if callable(sync_on) else sync_on)
    dt = time.time() - t0
    if result_holder is not None:
        result_holder[name] = dt
    if echo:
        import sys

        print(f"[phase] {name}: {dt * 1000:.1f} ms", file=sys.stderr)


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context (TensorBoard/Perfetto). A profiler that
    cannot start, or cannot write its trace, raises: a run asked to trace
    must not silently produce none. The directory is made first, so an
    unwritable one fails before a profiler session exists."""
    import os

    os.makedirs(log_dir, exist_ok=True)
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
