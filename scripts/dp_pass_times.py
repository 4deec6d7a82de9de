"""Time each DP pass, Triton kernel against the XLA-compiled scan, on a GPU.

For every pass of the differentiable DP (forward with residuals, score-only
forward, backward, adjoint forward, adjoint backward) and for the three
compositions the program runs (search scoring, decode, the training
gradient), both implementations run on the same inputs: outputs are
compared, then each is timed to completion over warmed repetitions.

    python scripts/dp_pass_times.py [--out .traces/dp_pass_times.json]
        [--trace DIR]

Shapes: the decode benchmark shape (B=256, 512x512, full lengths) and the
training step's DP shape (B=16, 512x512 buffer, lengths 64-512).  Exits
non-zero without a GPU.  ``--trace DIR`` also traces one decode call at the
benchmark shape on the default backend and prints the device time per
operation, which splits the kernels from the XLA relayouts around them.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from deepblast_jax.ops import dp as dp_ops  # noqa: E402
from deepblast_jax.ops import dp_scan, dp_triton  # noqa: E402
from deepblast_jax.ops.skew import skew  # noqa: E402
from deepblast_jax.utils.cache import enable_compile_cache  # noqa: E402
from deepblast_jax.utils.device import (  # noqa: E402
    card,
    device_info,
    require_gpu,
)
from deepblast_jax.utils.timing import time_fn  # noqa: E402

SHAPES = {
    "decode_b256_512": dict(B=256, N=512, M=512, ragged=False),
    "train_b16_512": dict(B=16, N=512, M=512, ragged=True),
}


def inputs(B, N, M, ragged, seed=0):
    rng = np.random.default_rng(seed)
    theta = rng.standard_normal((B, N, M)).astype(np.float32)
    A = (rng.standard_normal((B, N, M)) - 1.0).astype(np.float32)
    if ragged:
        ln = rng.integers(64, N + 1, B).astype(np.int32)
        lm = rng.integers(64, M + 1, B).astype(np.int32)
    else:
        ln = np.full(B, N, np.int32)
        lm = np.full(B, M, np.int32)
    return (jnp.asarray(theta), jnp.asarray(A), jnp.asarray(ln),
            jnp.asarray(lm))


def passes(theta, A, ln, lm, mode="nw", op="softmax"):
    """(name, scan_fn, triton_fn, args) for every pass."""
    td, ad = jax.jit(skew)(theta), jax.jit(skew)(A)
    _, qs = jax.jit(lambda *a: dp_scan.forward_scan(
        *a, mode=mode, operator=op))(td, ad, ln, lm)
    Et = jnp.ones(theta.shape[:1], theta.dtype)
    E = jax.jit(lambda *a: dp_scan.backward_scan(*a, mode=mode))(
        Et, qs, ln, lm)
    rng = np.random.default_rng(1)
    zt = jax.jit(skew)(jnp.asarray(
        rng.standard_normal(theta.shape).astype(np.float32)))
    _, qds = jax.jit(lambda *a: dp_scan.adjoint_forward_scan(
        *a, mode=mode, operator=op))(qs, zt, jnp.zeros_like(zt), ln, lm)
    kw = dict(mode=mode, operator=op)
    return [
        ("forward", lambda *a: dp_scan.forward_scan(*a, **kw),
         lambda *a: dp_triton.forward(*a, **kw), (td, ad, ln, lm)),
        ("forward_score", lambda *a: dp_scan.forward_scan(*a, **kw)[0],
         lambda *a: dp_triton.forward_score(*a, **kw), (td, ad, ln, lm)),
        ("backward", lambda *a: dp_scan.backward_scan(*a, mode=mode),
         lambda *a: dp_triton.backward(*a, mode=mode), (Et, qs, ln, lm)),
        ("adjoint_forward",
         lambda q, z, l1, l2: dp_scan.adjoint_forward_scan(
             q, z, jnp.zeros_like(z), l1, l2, **kw),
         lambda q, z, l1, l2: dp_triton.adjoint_forward(
             q, z, None, l1, l2, **kw), (qs, zt, ln, lm)),
        ("adjoint_backward",
         lambda *a: dp_scan.adjoint_backward_scan(*a, mode=mode),
         lambda *a: dp_triton.adjoint_backward(*a, mode=mode),
         (E, qs, qds, ln, lm)),
    ]


def compositions(theta, A, ln, lm, mode="nw", op="softmax"):
    W = jnp.asarray(np.random.default_rng(2).standard_normal(
        theta.shape).astype(np.float32))

    def score(backend):
        return lambda th, a, l1, l2: dp_ops.alignment_score(
            th, a, (l1, l2), mode=mode, operator=op, backend=backend)

    def decode(backend):
        return lambda th, a, l1, l2: dp_ops.expected_alignment_stream(
            th, a, (l1, l2), mode=mode, operator=op, backend=backend)

    def train_grad(backend):
        def loss(th, a, l1, l2):
            E = dp_ops.expected_alignment(th, a, (l1, l2), mode=mode,
                                          operator=op, backend=backend)
            return jnp.sum(E * W)
        return jax.grad(loss, argnums=(0, 1))

    return [("score", score), ("decode", decode), ("train_grad", train_grad)]


def device_op_times(trace_dir):
    """Device nanoseconds per event name, per timeline, of the GPU planes
    in a profiler trace: ``{(plane, line): Counter(name -> ns)}``."""
    from jax.profiler import ProfileData
    path = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                     recursive=True)[0]
    lines = collections.defaultdict(collections.Counter)
    for plane in ProfileData.from_file(path).planes:
        if "GPU" not in plane.name:
            continue
        for line in plane.lines:
            for ev in line.events:
                lines[(plane.name, line.name)][ev.name] += ev.duration_ns
    return lines


def max_diff(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    return max(float(jnp.max(jnp.abs(x - y))) for x, y in zip(la, lb))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=".traces/dp_pass_times.json")
    p.add_argument("--trace", default=None)
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args(argv)
    require_gpu("dp_pass_times.py")
    enable_compile_cache()
    rows = []
    print(card())
    print(f"device: {device_info()}")
    for shape_name, sh in SHAPES.items():
        theta, A, ln, lm = inputs(**sh)
        todo = [(n, s, t, a) for n, s, t, a in passes(theta, A, ln, lm)]
        todo += [(n, f("scan"), f("triton"), (theta, A, ln, lm))
                 for n, f in compositions(theta, A, ln, lm)]
        for name, scan_fn, tri_fn, a in todo:
            js, jt = jax.jit(scan_fn), jax.jit(tri_fn)
            diff = max_diff(js(*a), jt(*a))
            ts = time_fn(js, *a, iters=args.iters)
            tt = time_fn(jt, *a, iters=args.iters)
            row = dict(shape=shape_name, what=name, max_abs_diff=diff,
                       scan_ms=1e3 * float(np.median(ts)),
                       triton_ms=1e3 * float(np.median(tt)),
                       scan_samples_ms=[1e3 * x for x in ts],
                       triton_samples_ms=[1e3 * x for x in tt])
            row["speedup"] = row["scan_ms"] / row["triton_ms"]
            rows.append(row)
            print(f"{shape_name:18s} {name:17s} scan {row['scan_ms']:9.3f} ms"
                  f"  triton {row['triton_ms']:9.3f} ms"
                  f"  x{row['speedup']:7.2f}  max|diff| {diff:.2e}",
                  flush=True)
        if args.trace and shape_name.startswith("decode"):
            backend = dp_ops.get_backend(None)[0]
            fn = jax.jit(dict(compositions(theta, A, ln, lm))["decode"](
                backend))
            jax.block_until_ready(fn(theta, A, ln, lm))
            with jax.profiler.trace(args.trace):
                jax.block_until_ready(fn(theta, A, ln, lm))
            timelines = device_op_times(args.trace)
            if not timelines:
                print("trace holds no GPU plane")
            for (plane, line), ops in timelines.items():
                busy = sum(ops.values())
                print(f"trace of one {backend} decode, {plane} / {line}: "
                      f"{len(ops)} names, {busy / 1e6:.3f} ms")
                for name, ns in ops.most_common(8):
                    print(f"  {name[:60]:60s} {ns / 1e6:9.3f} ms  "
                          f"{100 * ns / busy:5.1f}%")
    out = dict(card=card(), device=device_info(), rows=rows)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
