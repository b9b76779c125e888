"""Per-stage timing harness (SURVEY.md §5 tracing/profiling row).

The reference hand-rolls std::chrono spans around each rasterizer stage and
prints averages every 100 frames (tiled_rasterizer.mm:639-671).  Here
per-dispatch wall-clock would measure the asynchronous enqueue plus a host
round trip, so stages are timed by running K iterations inside ONE jitted
lax.fori_loop and differencing two K values: exactly one dispatch + one
transfer per measurement.

jax.profiler.trace / start_server are also re-exported for xprof capture on
hosts with direct device access.
"""

from __future__ import annotations

import time
from typing import Callable

import jax

from jax.profiler import start_server, trace  # noqa: F401  (re-export)


def loop_time_ms(
    fn: Callable,
    args: tuple,
    k_small: int = 2,
    k_large: int = 12,
    repeats: int = 3,
) -> float:
    """Per-iteration milliseconds of ``fn(*args)``.

    fn must map its first argument to an output of the same pytree structure
    (a fixed point signature), so it can carry through lax.fori_loop; the rest
    of ``args`` are closed over.  Returns (T(k_large) - T(k_small)) /
    (k_large - k_small).
    """
    first, rest = args[0], args[1:]

    def make(k: int):
        def run(x0):
            return jax.lax.fori_loop(0, k, lambda i, x: fn(x, *rest), x0)

        return jax.jit(run)

    f_small, f_large = make(k_small), make(k_large)

    def measure(f):
        out = f(first)
        jax.tree_util.tree_map(lambda a: a.block_until_ready(), out)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = f(first)
            jax.tree_util.tree_map(lambda a: a.block_until_ready(), out)
            best = min(best, time.perf_counter() - t0)
        return best

    t_small = measure(f_small)
    t_large = measure(f_large)
    return (t_large - t_small) / (k_large - k_small) * 1000.0
