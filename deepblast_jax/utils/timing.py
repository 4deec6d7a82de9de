"""Device timing: wall clock around calls that end in ``block_until_ready``.

JAX dispatches asynchronously, so a time taken without waiting for the
result measures the enqueue only.  :func:`time_fn` warms the function up
(compilation is set-up, not part of the samples), then times each call to
completion.
"""

from __future__ import annotations

import time

import jax

__all__ = ["time_fn"]


def time_fn(fn, *args, warmup=2, iters=10):
    """Seconds per call of ``fn(*args)``, one sample per call, after
    ``warmup`` untimed calls."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        samples.append(time.perf_counter() - t0)
    return samples
