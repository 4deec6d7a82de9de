"""``deepblast-benchmark`` — kernel/throughput sweeps.

Replicates the reference perf harness configs (batch {4..256} at 800x800 and
lengths {64..1024} at B=64, reference: deepblast/tests/profile_nw.py:45-76;
mean fwd+bwd at B=1024 800x800, reference: deepblast/tests/cuda_timing.py)
plus backend and pass-depth dimensions specific to this framework.
"""

from __future__ import annotations

import argparse
import json


def run_config(B, N, M, mode, backend, depth, iters):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from deepblast_jax.ops import dp as dp_ops
    from deepblast_jax.utils.timing import time_fn

    rng = np.random.default_rng(0)
    theta = jnp.asarray(rng.standard_normal((B, N, M)), jnp.float32)
    A = jnp.asarray(rng.standard_normal((B, N, M)) - 1.0, jnp.float32)
    ln = jnp.full((B,), N, jnp.int32)
    lm = jnp.full((B,), M, jnp.int32)

    if depth == "fwd":
        def op(theta, A):
            return dp_ops.alignment_score(
                theta, A, (ln, lm), mode=mode, backend=backend)
    elif depth == "fwd+bwd":
        def op(theta, A):
            return dp_ops.expected_alignment(
                theta, A, (ln, lm), mode=mode, backend=backend)
    elif depth == "decode":
        # the inference product path (what bench.py times): expected
        # alignment in the stream layout, no unskew
        def op(theta, A):
            return dp_ops.expected_alignment_stream(
                theta, A, (ln, lm), mode=mode, backend=backend)
    else:  # train: gradient through the decode (2nd-order path)
        def op(theta, A):
            def loss(t, a):
                E = dp_ops.expected_alignment(
                    t, a, (ln, lm), mode=mode, backend=backend)
                return jnp.sum(E * E)
            return jax.grad(loss, argnums=(0, 1))(theta, A)

    dt = float(np.median(time_fn(jax.jit(op), theta, A, iters=iters)))
    dev = jax.devices()[0]
    return dict(B=B, N=N, M=M, mode=mode,
                backend=dp_ops.get_backend(backend)[0], depth=depth,
                device=dict(platform=dev.platform, kind=dev.device_kind,
                            count=len(jax.devices())),
                seconds=dt, alignments_per_sec=B / dt,
                cell_updates_per_sec=B * N * M / dt)


def main(argv=None):
    parser = argparse.ArgumentParser("deepblast-benchmark")
    parser.add_argument("--sweep", choices=["batch", "length", "headline"],
                        default="headline")
    parser.add_argument("--mode", default="nw", choices=["nw", "sw"])
    parser.add_argument("--backend", default=None,
                        choices=[None, "scan", "triton"])
    parser.add_argument("--depth", default="fwd+bwd",
                        choices=["fwd", "fwd+bwd", "decode", "train"])
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--length", type=int, default=512)
    parser.add_argument("--batch-size", type=int, default=64)
    args = parser.parse_args(argv)

    if args.sweep == "batch":
        configs = [(b, 800, 800) for b in (4, 8, 16, 32, 64, 128, 256)]
    elif args.sweep == "length":
        configs = [(args.batch_size, n, n)
                   for n in (64, 128, 256, 512, 1024)]
    else:
        configs = [(args.batch_size, args.length, args.length)]

    for B, N, M in configs:
        res = run_config(B, N, M, args.mode, args.backend, args.depth,
                         args.iters)
        print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
