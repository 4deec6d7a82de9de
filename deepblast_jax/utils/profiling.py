"""Profiling helpers (reference: the commented-out Lightning
AdvancedProfiler at scripts/deepblast-train:54 and the manual harnesses in
tests/profile_nw.py — here backed by jax.profiler)."""

from __future__ import annotations

import contextlib
import os
import time

import jax

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

__all__ = ["trace", "timed"]


@contextlib.contextmanager
def trace(logdir=os.path.join(_REPO, ".traces")):
    """Capture a jax.profiler trace viewable in TensorBoard/Perfetto
    (by default under ``.traces/`` in the checkout)."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timed(label, sink=print):
    t0 = time.perf_counter()
    yield
    sink(f"{label}: {(time.perf_counter() - t0) * 1e3:.2f} ms")
