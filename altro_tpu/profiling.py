"""Timing / tracing harness.

The reference times MPC loops ad hoc with chrono
(bicycle_test.cpp:301,338-342) and never populates its stats' solve_time.
This module provides the JAX equivalents (SURVEY §5): a
block_until_ready timing harness reporting solves/s and latency
percentiles, and an optional `jax.profiler` trace context.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict

import jax
import numpy as np

__all__ = ["time_fn", "benchmark_solves", "trace"]


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 1) -> Dict[str, float]:
    """Run fn(*args) `iters` times (after `warmup` compile runs); returns
    wall-clock stats in milliseconds (p50/p90/p99/mean)."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        samples.append((time.perf_counter() - t0) * 1e3)
    s = np.asarray(samples)
    return {
        "p50_ms": float(np.percentile(s, 50)),
        "p90_ms": float(np.percentile(s, 90)),
        "p99_ms": float(np.percentile(s, 99)),
        "mean_ms": float(s.mean()),
        "iters": iters,
    }


def benchmark_solves(fn: Callable, *args, batch: int, iters: int = 10) -> Dict[str, float]:
    """Timing stats plus solves/s for a batched solve callable."""
    stats = time_fn(fn, *args, iters=iters)
    stats["solves_per_s"] = batch / (stats["p50_ms"] / 1e3)
    stats["batch"] = batch
    return stats


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace context (view with TensorBoard / xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
