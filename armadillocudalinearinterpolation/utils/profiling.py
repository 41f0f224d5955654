"""Profiling helper (SURVEY.md §5: the reference has no profiling hooks at
all; wall-clock was measured externally).

:func:`trace` is a context manager around ``jax.profiler`` producing a
TensorBoard/perfetto trace directory.  Times are taken with the host clock
around work that ends in ``jax.block_until_ready`` (``bench.py``,
``chip_smoke.py``).
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("/tmp/trace"):`` — profile the enclosed device work."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
