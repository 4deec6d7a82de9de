"""Anti-diagonal ("skewed") layout transforms for wavefront DP.

The alignment recursion has a dependency structure where every cell ``(i, j)``
depends on ``(i-1, j)``, ``(i, j-1)`` and ``(i-1, j-1)`` — so all cells on an
anti-diagonal ``k = i + j`` are independent and can be computed as one vector
operation.  We therefore re-lay the ``(B, N, M)`` potential matrices
into *diagonal-major* form ``(K, B, N)`` with ``K = N + M - 1`` where row
``d`` holds anti-diagonal ``d``:

    skewed[d, b, i] = x[b, i, d - i]        (0 <= d - i < M)

Out-of-range entries are zero.  A `lax.scan` (or the loop inside a Triton
kernel) then walks the leading diagonal axis, and every step is a dense
``(B, N)`` operation with unit-stride access — the counterpart of the
reference CUDA kernel's per-thread serial loop
(reference: deepblast/nw_cuda.py:46-79), but with ``B x N``-way parallelism
per step instead of ``B``-way.

Implementation note: both transforms are pure pad/reshape/transpose layout
ops — no gather.  Shifting row ``i`` right by ``i`` positions is the same as
re-reading an ``(N, N+M)`` row-major buffer with row stride ``N+M-1``, so a
zero-pad followed by a flat reshape with the shorter stride performs the
whole skew, which XLA fuses into copies.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["skew", "unskew", "num_diagonals"]


def num_diagonals(N: int, M: int) -> int:
    return N + M - 1


def skew(x):
    """``(B, N, M) -> (K, B, N)`` diagonal-major layout, ``K = N + M - 1``.

    ``skew(x)[d, b, i] == x[b, i, d - i]`` where valid, else 0.
    """
    B, N, M = x.shape
    K = N + M - 1
    W = M + N
    y = jnp.pad(x, ((0, 0), (0, 0), (0, N)))            # (B, N, W)
    flat = y.reshape(B, N * W)[:, :N * (W - 1)]
    z = flat.reshape(B, N, W - 1)[:, :, :K]             # z[b, i, d]
    return jnp.transpose(z, (2, 0, 1))


def unskew(s, N: int, M: int, offset: int = 0):
    """Inverse of :func:`skew` for diagonal buffers of slot width ``L``.

    ``s[d, b, i]`` holds the value of matrix cell ``(i - offset, d - i +
    offset)`` — i.e. DP quantities whose slot index ``i`` is the (1-based,
    when ``offset=1``) DP row stored on diagonal ``k = i + j`` at row
    ``d = k - 2``.  Returns ``out (B, N, M)`` with
    ``out[b, r, c] = s[r + c, b, r + offset]``.
    """
    K, B, L = s.shape
    st = jnp.transpose(s, (1, 2, 0))                    # (B, L, K)
    u = st[:, offset:offset + N, :]                     # (B, N, K)
    flat = jnp.pad(u.reshape(B, N * K), ((0, 0), (0, N)))
    return flat.reshape(B, N, K + 1)[:, :, :M]
