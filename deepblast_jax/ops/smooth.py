"""Smoothed-max operator family over the three DP transition arguments.

Re-design of the reference smooth-max operators
(reference: deepblast/ops.py:4-70).  Instead of operating on a stacked
``(..., 3)`` tensor, every operator is specialised to the 3-argument form used
by the alignment recursion and is written so that the three argument planes
stay separate arrays: elementwise code over the diagonal that runs unchanged
in the scan passes and inside the Triton kernels, with no degenerate 3-wide
minor dimension.

Each operator provides:

``max3(ax, am, ay) -> (val, (px, pm, py))``
    The smoothed maximum of the three arguments and its gradient (the
    smoothed argmax probabilities).

``hessian3((px, pm, py), (zx, zm, zy)) -> (hx, hm, hy)``
    The Hessian-vector product of the smoothed max, needed by the adjoint
    (double-backward) DP passes (reference: deepblast/ops.py:29-32,61-66).

All functions are shape-polymorphic and jit/vmap/Pallas friendly.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "max3",
    "hessian3",
    "OPERATORS",
]


# ---------------------------------------------------------------------------
# softmax (log-sum-exp) — the operator used by training in the reference
# (reference: deepblast/ops.py:18-32, deepblast/nw.py:10-27).
# ---------------------------------------------------------------------------

def _softmax_max3(ax, am, ay):
    mx = jnp.maximum(jnp.maximum(ax, am), ay)
    ex = jnp.exp(ax - mx)
    em = jnp.exp(am - mx)
    ey = jnp.exp(ay - mx)
    s = ex + em + ey
    inv = 1.0 / s
    val = mx + jnp.log(s)
    return val, (ex * inv, em * inv, ey * inv)


def _softmax_hessian3(p, z):
    px, pm, py = p
    zx, zm, zy = z
    prodx = px * zx
    prodm = pm * zm
    prody = py * zy
    tot = prodx + prodm + prody
    return (prodx - px * tot, prodm - pm * tot, prody - py * tot)


# ---------------------------------------------------------------------------
# sparsemax — Euclidean projection of the 3-vector onto the simplex
# (reference: deepblast/ops.py:35-66).  Closed form for 3 elements via a
# sorting network, so it vectorises with no data-dependent control flow.
# ---------------------------------------------------------------------------

def _sparsemax_max3(ax, am, ay):
    a_hi = jnp.maximum(ax, am)
    a_lo = jnp.minimum(ax, am)
    z1 = jnp.maximum(a_hi, ay)
    z3 = jnp.minimum(a_lo, ay)
    z2 = jnp.maximum(a_lo, jnp.minimum(a_hi, ay))

    # Support-size selection: cond_k = z_k - (cssv_k / k) > 0, with
    # cssv_k = sum_{j<=k} z_j - 1.  cond_1 always holds.
    c1 = z1 + z2 - 1.0
    c2 = c1 + z3
    cond2 = (2.0 * z2 > c1).astype(z1.dtype)
    cond3 = (3.0 * z3 > c2).astype(z1.dtype)
    rho = 1.0 + cond2 + cond3
    cssv = (z1 - 1.0) + cond2 * z2 + cond3 * z3
    tau = cssv / rho

    px = jnp.maximum(ax - tau, 0.0)
    pm = jnp.maximum(am - tau, 0.0)
    py = jnp.maximum(ay - tau, 0.0)
    # M = sum_i p_i (a_i - p_i / 2)  (reference: deepblast/ops.py:57)
    val = px * (ax - 0.5 * px) + pm * (am - 0.5 * pm) + py * (ay - 0.5 * py)
    return val, (px, pm, py)


def _sparsemax_hessian3(p, z):
    px, pm, py = p
    zx, zm, zy = z
    dt = px.dtype
    sx = (px > 0).astype(dt)
    sm = (pm > 0).astype(dt)
    sy = (py > 0).astype(dt)
    support = sx + sm + sy
    prodx = sx * zx
    prodm = sm * zm
    prody = sy * zy
    avg = (prodx + prodm + prody) / jnp.maximum(support, 1.0)
    return (prodx - sx * avg, prodm - sm * avg, prody - sy * avg)


# ---------------------------------------------------------------------------
# hardmax — exact max; argmax probabilities split ties evenly
# (reference: deepblast/ops.py:4-15).
# ---------------------------------------------------------------------------

def _hardmax_max3(ax, am, ay):
    val = jnp.maximum(jnp.maximum(ax, am), ay)
    dt = ax.dtype
    ix = (ax == val).astype(dt)
    im = (am == val).astype(dt)
    iy = (ay == val).astype(dt)
    inv = 1.0 / (ix + im + iy)
    return val, (ix * inv, im * inv, iy * inv)


def _hardmax_hessian3(p, z):
    zx, zm, zy = z
    zero = jnp.zeros_like(zx)
    return (zero, zero, zero)


OPERATORS = {
    "softmax": (_softmax_max3, _softmax_hessian3),
    "sparsemax": (_sparsemax_max3, _sparsemax_hessian3),
    "hardmax": (_hardmax_max3, _hardmax_hessian3),
}


def max3(operator: str, ax, am, ay):
    """Smoothed max of the three DP transition arguments.

    Returns ``(val, (px, pm, py))`` where the probabilities are the gradient
    of ``val`` w.r.t. the arguments (softargmax).
    """
    return OPERATORS[operator][0](ax, am, ay)


def hessian3(operator: str, p, z):
    """Hessian-vector product of the smoothed max at probabilities ``p``
    applied to tangents ``z`` (both 3-tuples of arrays)."""
    return OPERATORS[operator][1](p, z)
