"""Profiling / tracing harness (SURVEY.md §5.1 — absent in the reference;
this is the jax.profiler-based equivalent).

Usage::

    with trace("/tmp/mgp_trace"):      # view in TensorBoard / Perfetto
        state, loss = step(state, X, Y)
        jax.block_until_ready(loss)

    t = time_fn(lambda: step(state, X, Y))   # robust wall timing
"""
from __future__ import annotations

import contextlib
import time

import jax

__all__ = ["trace", "time_fn", "flops_estimate"]


@contextlib.contextmanager
def trace(log_dir: str):
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_fn(fn, *args, iters: int = 10, warmup: int = 2):
    """Best-of host wall time per call, each call ended by
    ``block_until_ready`` after ``warmup`` untimed calls."""
    for _ in range(warmup):
        out = fn(*args)
        jax.block_until_ready(out)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best


def flops_estimate(fn, *args) -> float:
    """XLA's cost-analysis FLOP count for a jitted function."""
    lowered = jax.jit(fn).lower(*args)
    compiled = lowered.compile()
    analysis = compiled.cost_analysis()
    if isinstance(analysis, list):
        analysis = analysis[0]
    return float(analysis.get("flops", -1.0)) if analysis else -1.0
