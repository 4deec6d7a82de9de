#!/usr/bin/env python3
"""Len-512 decode throughput on one GPU.

Times the expected-alignment decode (forward + backward DP passes, the
stream layout that the traceback walks) of B=256 pairs of 512x512,
Needleman-Wunsch, fp32, on the platform's default DP backend, and prints
one JSON line: alignments per second from the median of warmed calls, each
ended by ``block_until_ready``, with every sample, the device as JAX
reports it and the card's name and power limit.

    python bench.py

Exits non-zero when JAX finds no GPU: no other platform stands in for it.
"""

from __future__ import annotations

import json
import time

B, N, M = 256, 512, 512


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from deepblast_jax.ops import dp as dp_ops
    from deepblast_jax.utils.cache import enable_compile_cache
    from deepblast_jax.utils.device import card, device_info, require_gpu
    from deepblast_jax.utils.timing import time_fn

    require_gpu("bench.py")
    enable_compile_cache()
    backend, _ = dp_ops.get_backend(None)
    rng = np.random.default_rng(0)
    theta = jnp.asarray(rng.standard_normal((B, N, M)), jnp.float32)
    A = jnp.asarray(rng.standard_normal((B, N, M)) - 1.0, jnp.float32)
    lengths = (jnp.full((B,), N, jnp.int32), jnp.full((B,), M, jnp.int32))

    decode = jax.jit(lambda th, a, ls: dp_ops.expected_alignment_stream(
        th, a, ls, mode="nw", backend=backend))
    t0 = time.perf_counter()
    jax.block_until_ready(decode(theta, A, lengths))
    compile_s = time.perf_counter() - t0
    samples = time_fn(decode, theta, A, lengths, warmup=2, iters=20)
    med = float(np.median(samples))
    print(json.dumps({
        "metric": "len-512 decode alignments/s (soft-NW fwd+bwd, B=256, "
                  "fp32)",
        "value": B / med,
        "unit": "alignments/s",
        "median_ms": 1e3 * med,
        "min_ms": 1e3 * min(samples),
        "samples_ms": [1e3 * s for s in samples],
        "first_call_s": compile_s,
        "backend": backend,
        "device": device_info(),
        "card": card(),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
