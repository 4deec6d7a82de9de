"""Batched wavefront (anti-diagonal) smoothed-DP passes in pure `jax.numpy`.

These four passes are the XLA-portable implementation of the differentiable
alignment core, and the oracle for the GPU kernels of
:mod:`deepblast_jax.ops.dp_triton` — a re-design of the reference kernels
(reference: deepblast/nw.py:46-267, deepblast/sw.py:46-209, and the CUDA
variants deepblast/nw_cuda.py:46-165).  Where the reference runs one serial
O(N*M) loop per batch element (one CUDA thread per pair,
deepblast/nw_cuda.py:74-79), each pass here is a `lax.scan` over the
``K = N + M - 1`` anti-diagonals whose step is a dense ``(B, N+1)`` vector
operation — every cell of a diagonal and every pair of the batch advances in
parallel.

Layout: all per-cell quantities travel in the diagonal-major layout produced
by :mod:`deepblast_jax.ops.skew`.  A DP-matrix quantity indexed by
``(i, j)`` with ``i ∈ [0, N]`` lives on diagonal ``k = i + j`` at slot ``i``
of a length ``N+1`` buffer; diagonal ``k`` is stored at row ``k - 2`` (the
first diagonal any pass updates).

Variable lengths: the batch is padded to a static ``(N, M)`` and each pair
carries its true lengths ``(ln, lm)``.  Because the recursion only reads
cells with smaller indices, padding can never contaminate the valid region;
validity masks simply (a) pin border/padding cells to the reference's zero
boundary values and (b) select the per-pair terminal cell ``V[ln, lm]``.

All passes are linear-time in ``K`` with O(B * N) state — sequence length is
bounded by device memory for the stored soft-argmax diagonals only (no 2048 cap as in
deepblast/nw_cuda.py:11).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from deepblast_jax.ops import smooth

__all__ = [
    "forward_scan",
    "backward_scan",
    "adjoint_forward_scan",
    "adjoint_backward_scan",
    "MODE_BOUNDS",
]

# Lower loop bounds per pass: (forward, backward, adjoint_fwd, adjoint_bwd).
# NW is the global alignment (all 1); the reference's SW variant starts its
# forward at 2 and truncates its backward (deepblast/sw.py:54-55,107-109).
# NOTE: the reference's SW *adjoint* passes run full-range
# (deepblast/sw.py:148-150,197-200), which makes its SW second-order
# gradients inconsistent with its own forward recursion (tangents leak
# through the never-computed first row/column).  We use the mathematically
# correct restricted bounds — verified against plain double-autodiff through
# the forward scan in tests/test_dp_scan.py.
MODE_BOUNDS = {
    "nw": (1, 1, 1, 1),
    "sw": (2, 2, 2, 2),
}


def _shr(v):
    """shift right along the slot axis: out[..., i] = v[..., i-1], out[..., 0]=0."""
    return jnp.pad(v[..., :-1], [(0, 0)] * (v.ndim - 1) + [(1, 0)])


def _shl(v):
    """shift left along the slot axis: out[..., i] = v[..., i+1], out[..., -1]=0."""
    return jnp.pad(v[..., 1:], [(0, 0)] * (v.ndim - 1) + [(0, 1)])


def _padl(v):
    """prepend one zero slot: (B, N) -> (B, N+1) with out[:, i] = v[:, i-1]."""
    return jnp.pad(v, ((0, 0), (1, 0)))


def _valid_mask(iarr, k, ln, lm, lo):
    """Cells on diagonal ``k`` at slot ``i`` that the pass may update."""
    j = k - iarr
    return ((iarr >= lo) & (j >= lo)
            & (iarr <= ln[:, None]) & (j <= lm[:, None]))


def forward_scan(thetad, Ad, ln, lm, *, mode="nw", operator="softmax"):
    """Forward DP over anti-diagonals.

    Parameters
    ----------
    thetad, Ad : (K, B, N) skewed match / gap potentials (K = N + M - 1).
    ln, lm : (B,) int true lengths.

    Returns
    -------
    vt : (B,) terminal scores ``V[ln, lm]``.
    (qx, qm, qy) : each (K, B, N+1) — soft-argmax diagonals, zero outside the
        valid region (the backward pass relies on that masking).
    """
    K, B, N = thetad.shape
    lo = MODE_BOUNDS[mode][0]
    dtype = thetad.dtype
    iarr = jnp.arange(N + 1, dtype=jnp.int32)[None, :]
    ln = ln.astype(jnp.int32)
    lm = lm.astype(jnp.int32)
    ks = jnp.arange(K, dtype=jnp.int32) + 2

    def step(carry, xs):
        v1, v2, vt = carry
        td, ad, k = xs
        tsh = _padl(td)
        ash = _padl(ad)
        xarg = ash + _shr(v1)
        marg = _shr(v2)
        yarg = ash + v1
        val, (qx, qm, qy) = smooth.max3(operator, xarg, marg, yarg)
        vnew = tsh + val
        valid = _valid_mask(iarr, k, ln, lm, lo)
        zero = jnp.zeros((), dtype)
        vnew = jnp.where(valid, vnew, zero)
        qx = jnp.where(valid, qx, zero)
        qm = jnp.where(valid, qm, zero)
        qy = jnp.where(valid, qy, zero)
        term = (iarr == ln[:, None]) & (k == (ln + lm))[:, None]
        vt = vt + jnp.sum(jnp.where(term, vnew, zero), axis=1)
        return (vnew, v1, vt), (qx, qm, qy)

    zeros = jnp.zeros((B, N + 1), dtype)
    init = (zeros, zeros, jnp.zeros((B,), dtype))
    (_, _, vt), qs = lax.scan(step, init, (thetad, Ad, ks))
    return vt, qs


def backward_scan(Et, qs, ln, lm, *, mode="nw"):
    """Reverse DP computing the expected-alignment diagonals.

    ``E[i, j] = Qx[i+1, j] E[i+1, j] + Qm[i+1, j+1] E[i+1, j+1]
              + Qy[i, j+1] E[i, j+1]`` seeded with ``E[ln, lm] = Et``
    (equivalent to the reference's ``E[N+1, M+1] = Et, Q[N+1, M+1] = 1``
    corner seeding, deepblast/nw.py:125-127, because the masked ``Q`` kills
    every other contribution to the terminal cell).

    Returns ``Ediag`` of shape (K, B, N+1), masked like ``qs``.
    """
    qx, qm, qy = qs
    K, B, L = qx.shape
    N = L - 1
    lo = MODE_BOUNDS[mode][1]
    dtype = qx.dtype
    iarr = jnp.arange(N + 1, dtype=jnp.int32)[None, :]
    ln = ln.astype(jnp.int32)
    lm = lm.astype(jnp.int32)
    ks = jnp.arange(K, dtype=jnp.int32) + 2
    Et = Et.astype(dtype)

    def step(carry, xs):
        e1, e2, q1x, q1y, q1m, q2m = carry
        qx_k, qm_k, qy_k, k = xs
        enew = _shl(q1x * e1) + _shl(q2m * e2) + q1y * e1
        valid = _valid_mask(iarr, k, ln, lm, lo)
        zero = jnp.zeros((), dtype)
        enew = jnp.where(valid, enew, zero)
        seed = (iarr == ln[:, None]) & (k == (ln + lm))[:, None]
        enew = enew + jnp.where(seed, Et[:, None], zero)
        carry = (enew, e1, qx_k, qy_k, qm_k, q1m)
        return carry, enew

    zeros = jnp.zeros((B, N + 1), dtype)
    init = (zeros,) * 6
    _, Ediag = lax.scan(step, init, (qx, qm, qy, ks), reverse=True)
    return Ediag


def adjoint_forward_scan(qs, Ztd, ZAd, ln, lm, *, mode="nw",
                         operator="softmax"):
    """JVP of the forward pass along skewed tangents ``(Ztd, ZAd)``;
    ``ZAd=None`` is a zero gap tangent.

    Returns ``(vtd, (qdx, qdm, qdy))`` — the tangents of the terminal score
    and of the soft-argmax diagonals (via the operator's Hessian-product,
    reference: deepblast/nw.py:178-199).
    """
    qx, qm, qy = qs
    K, B, N = Ztd.shape
    lo = MODE_BOUNDS[mode][2]
    dtype = Ztd.dtype
    iarr = jnp.arange(N + 1, dtype=jnp.int32)[None, :]
    ln = ln.astype(jnp.int32)
    lm = lm.astype(jnp.int32)
    ks = jnp.arange(K, dtype=jnp.int32) + 2

    def step(carry, xs):
        vd1, vd2, vtd = carry
        ztd, zad, qx_k, qm_k, qy_k, k = xs
        ztsh = _padl(ztd)
        zash = 0.0 if zad is None else _padl(zad)
        xargd = zash + _shr(vd1)
        margd = _shr(vd2)
        yargd = zash + vd1
        vdnew = ztsh + qx_k * xargd + qm_k * margd + qy_k * yargd
        qdx, qdm, qdy = smooth.hessian3(
            operator, (qx_k, qm_k, qy_k), (xargd, margd, yargd))
        valid = _valid_mask(iarr, k, ln, lm, lo)
        zero = jnp.zeros((), dtype)
        vdnew = jnp.where(valid, vdnew, zero)
        qdx = jnp.where(valid, qdx, zero)
        qdm = jnp.where(valid, qdm, zero)
        qdy = jnp.where(valid, qdy, zero)
        term = (iarr == ln[:, None]) & (k == (ln + lm))[:, None]
        vtd = vtd + jnp.sum(jnp.where(term, vdnew, zero), axis=1)
        return (vdnew, vd1, vtd), (qdx, qdm, qdy)

    zeros = jnp.zeros((B, N + 1), dtype)
    init = (zeros, zeros, jnp.zeros((B,), dtype))
    (_, _, vtd), qds = lax.scan(step, init, (Ztd, ZAd, qx, qm, qy, ks))
    return vtd, qds


def adjoint_backward_scan(Ediag, qs, qds, ln, lm, *, mode="nw"):
    """Tangent of the backward pass (reference: deepblast/nw.py:251-267).

    ``Ed[i, j]`` accumulates the six-term product rule of the backward
    recursion.  The terminal seed has zero tangent, so no seeding is needed.
    Returns ``Eddiag`` of shape (K, B, N+1).
    """
    qx, qm, qy = qs
    qdx, qdm, qdy = qds
    K, B, L = qx.shape
    N = L - 1
    lo = MODE_BOUNDS[mode][3]
    dtype = Ediag.dtype
    iarr = jnp.arange(N + 1, dtype=jnp.int32)[None, :]
    ln = ln.astype(jnp.int32)
    lm = lm.astype(jnp.int32)
    ks = jnp.arange(K, dtype=jnp.int32) + 2

    def step(carry, xs):
        (ed1, ed2, e1, e2,
         q1x, q1y, q1m, q2m, qd1x, qd1y, qd1m, qd2m) = carry
        qx_k, qm_k, qy_k, qdx_k, qdm_k, qdy_k, e_k, k = xs
        ednew = (_shl(qd1x * e1 + q1x * ed1)
                 + _shl(qd2m * e2 + q2m * ed2)
                 + qd1y * e1 + q1y * ed1)
        valid = _valid_mask(iarr, k, ln, lm, lo)
        ednew = jnp.where(valid, ednew, jnp.zeros((), dtype))
        carry = (ednew, ed1, e_k, e1,
                 qx_k, qy_k, qm_k, q1m, qdx_k, qdy_k, qdm_k, qd1m)
        return carry, ednew

    zeros = jnp.zeros((B, N + 1), dtype)
    init = (zeros,) * 12
    _, Eddiag = lax.scan(
        step, init, (qx, qm, qy, qdx, qdm, qdy, Ediag, ks), reverse=True)
    return Eddiag
