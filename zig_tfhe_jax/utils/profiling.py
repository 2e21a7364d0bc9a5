"""Profiling/tracing helpers (aux subsystem; the reference has none —
SURVEY.md §5 — beyond ad-hoc wall-clock prints in examples).

- ``trace(logdir)``: context manager around jax.profiler for TensorBoard
  traces of the gate pipeline.
- ``time_op(fn, *args)``: robust wall-clock timing of a jitted op
  (compile excluded, block_until_ready included).
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(logdir: str):
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_op(fn, *args, iters: int = 3, warmup: int = 1):
    """Median seconds per call of fn(*args) with compile excluded."""
    import numpy as np

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))
