"""Plain-numpy ground-truth implementation of the smoothed alignment DP.

This module is the *semantic oracle* for the vectorised implementations:
a direct O(N*M) double loop over cells, single pair, float64.  It is only used
by the test-suite (and for tiny host-side debugging) — never on the hot path.

Semantics follow the reference CPU (numba) kernels:

* forward   (reference: deepblast/nw.py:46-62, deepblast/sw.py:46-61)
* backward  (reference: deepblast/nw.py:120-135, deepblast/sw.py:100-115)
* adjoint forward  (reference: deepblast/nw.py:178-199, deepblast/sw.py:140-162)
* adjoint backward (reference: deepblast/nw.py:251-267, deepblast/sw.py:192-209)

The gap matrix is indexed ``A[i-1, j-1]`` (per-cell gap potential), i.e. the
reference *CPU* semantics; the reference CUDA kernels' rolling-buffer indexing
bug (deepblast/nw_cuda.py:61-63) is intentionally not reproduced.

Needleman-Wunsch (global) uses lower bound 1 in every pass; Smith-Waterman
(the reference's "local" variant) starts forward at 2 and stops the backward
recursion before the first row/column (deepblast/sw.py:54-55,107-109) while
keeping full-range adjoint passes (deepblast/sw.py:148-150,197-200).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "BOUNDS",
    "forward",
    "backward",
    "adjoint_forward",
    "adjoint_backward",
]

# (forward_lo, backward_lo, adjoint_forward_lo, adjoint_backward_lo)
# The reference's SW adjoint passes run full-range (deepblast/sw.py:148-150,
# 197-200) — a bug: tangents then flow through cells its forward never
# computes, so its SW second-order gradients disagree with finite
# differences of its own forward.  We use the consistent restricted bounds.
BOUNDS = {
    "nw": (1, 1, 1, 1),
    "sw": (2, 2, 2, 2),
}


def _softmax3(v):
    mx = np.max(v)
    e = np.exp(v - mx)
    s = e.sum()
    return mx + np.log(s), e / s


def _sparsemax3(v):
    z = np.sort(v)[::-1]
    cssv = np.cumsum(z) - 1.0
    k = np.arange(1, 4)
    cond = z - cssv / k > 0
    rho = int(cond.sum())
    tau = cssv[rho - 1] / rho
    p = np.maximum(v - tau, 0.0)
    val = float(np.sum(p * (v - 0.5 * p)))
    return val, p


def _hardmax3(v):
    mx = np.max(v)
    p = (v == mx).astype(v.dtype)
    return mx, p / p.sum()


def _softmax3_hess(p, z):
    prod = p * z
    return prod - p * prod.sum()


def _sparsemax3_hess(p, z):
    s = (p > 0).astype(p.dtype)
    prod = s * z
    return prod - s * prod.sum() / s.sum()


def _hardmax3_hess(p, z):
    return np.zeros_like(z)


_MAX = {"softmax": _softmax3, "sparsemax": _sparsemax3, "hardmax": _hardmax3}
_HESS = {
    "softmax": _softmax3_hess,
    "sparsemax": _sparsemax3_hess,
    "hardmax": _hardmax3_hess,
}


def forward(theta, A, mode="nw", operator="softmax"):
    """Returns ``(Vt, V, Q)``; ``V`` is ``(N+1, M+1)``, ``Q`` ``(N+2, M+2, 3)``
    with state order (x, m, y) = (0, 1, 2)."""
    theta = np.asarray(theta, dtype=np.float64)
    A = np.asarray(A, dtype=np.float64)
    N, M = theta.shape
    lo = BOUNDS[mode][0]
    maxf = _MAX[operator]
    V = np.zeros((N + 1, M + 1))
    Q = np.zeros((N + 2, M + 2, 3))
    for i in range(lo, N + 1):
        for j in range(lo, M + 1):
            args = np.array([
                A[i - 1, j - 1] + V[i - 1, j],      # x
                V[i - 1, j - 1],                    # m
                A[i - 1, j - 1] + V[i, j - 1],      # y
            ])
            v, Q[i, j] = maxf(args)
            V[i, j] = theta[i - 1, j - 1] + v
    return V[N, M], V, Q


def backward(Et, Q, mode="nw"):
    """Returns ``E`` of shape ``(N+2, M+2)`` — the expected alignment
    (marginals) seeded with terminal cotangent ``Et``."""
    Q = np.array(Q, dtype=np.float64, copy=True)
    N, M = Q.shape[0] - 2, Q.shape[1] - 2
    lo = BOUNDS[mode][1]
    E = np.zeros((N + 2, M + 2))
    E[N + 1, M + 1] = Et
    Q[N + 1, M + 1] = 1.0
    for i in range(N, lo - 1, -1):
        for j in range(M, lo - 1, -1):
            E[i, j] = (Q[i + 1, j, 0] * E[i + 1, j]
                       + Q[i + 1, j + 1, 1] * E[i + 1, j + 1]
                       + Q[i, j + 1, 2] * E[i, j + 1])
    return E


def adjoint_forward(Q, Ztheta, ZA, mode="nw", operator="softmax"):
    """JVP of the forward pass along direction ``(Ztheta, ZA)`` (both N x M).

    Returns ``(Vtd, Vd, Qd)``.  Note the reference passes ``Ztheta`` padded to
    ``(N+2, M+2)`` and reads ``Ztheta[i, j]`` (deepblast/nw.py:193); here the
    tangent is taken in natural N x M coordinates, i.e. ``Ztheta[i-1, j-1]``.
    """
    Ztheta = np.asarray(Ztheta, dtype=np.float64)
    ZA = np.asarray(ZA, dtype=np.float64)
    N, M = Ztheta.shape
    lo = BOUNDS[mode][2]
    hess = _HESS[operator]
    Vd = np.zeros((N + 1, M + 1))
    Qd = np.zeros((N + 2, M + 2, 3))
    for i in range(lo, N + 1):
        for j in range(lo, M + 1):
            zargs = np.array([
                ZA[i - 1, j - 1] + Vd[i - 1, j],
                Vd[i - 1, j - 1],
                ZA[i - 1, j - 1] + Vd[i, j - 1],
            ])
            Vd[i, j] = Ztheta[i - 1, j - 1] + float(Q[i, j] @ zargs)
            Qd[i, j] = hess(Q[i, j], zargs)
    return Vd[N, M], Vd, Qd


def adjoint_backward(E, Q, Qd, mode="nw"):
    """Tangent of the backward pass: returns ``Ed`` of shape ``(N+2, M+2)``."""
    N, M = Q.shape[0] - 2, Q.shape[1] - 2
    lo = BOUNDS[mode][3]
    Ed = np.zeros((N + 2, M + 2))
    for i in range(N, lo - 1, -1):
        for j in range(M, lo - 1, -1):
            Ed[i, j] = (Qd[i + 1, j, 0] * E[i + 1, j]
                        + Q[i + 1, j, 0] * Ed[i + 1, j]
                        + Qd[i + 1, j + 1, 1] * E[i + 1, j + 1]
                        + Q[i + 1, j + 1, 1] * Ed[i + 1, j + 1]
                        + Qd[i, j + 1, 2] * E[i, j + 1]
                        + Q[i, j + 1, 2] * Ed[i, j + 1])
    return Ed
