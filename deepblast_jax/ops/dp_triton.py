"""Wavefront smoothed-DP passes as Pallas kernels for the GPU (Triton route).

Each of the four passes of :mod:`deepblast_jax.ops.dp_scan` (plus a
score-only forward) is one ``pallas_call`` with ``backend="triton"``: the
grid runs one program per pair of the batch, and the program loops over the
``K = N + M - 1`` anti-diagonals inside the kernel, the way the reference's
CUDA kernels loop over the whole recursion inside one thread
(deepblast/nw_cuda.py:46-79) -- but here every cell of a diagonal advances
together, spread over the program's threads.

Layout (identical to :mod:`dp_scan`, so either implementation's residuals
feed the other's reverse passes):

* potentials and tangents arrive skewed, ``(K, B, N)``, from
  :func:`deepblast_jax.ops.skew.skew`;
* soft-argmax residuals and expectation diagonals leave as ``(K, B, N+1)``
  with slot ``i`` holding DP row ``i`` of diagonal ``k = r + 2``.

Lane ``t`` of a program holds slot ``i = t + 1``; slot 0 is a border cell that
no pass ever updates, so ``P = next_pow2(N)`` lanes cover a diagonal.  The
recursion reads the two previous diagonals at slot offsets ``-1`` / ``+1``,
which is a shift across threads.  Each program therefore keeps its last three
diagonals in a small ring buffer in device memory (an extra output that stays
L1/L2-resident), stores the new diagonal there, and re-reads it shifted after
a block barrier.  Three rows with one barrier per diagonal are enough: a row
is only overwritten two diagonals after its last read.

Rows beyond a pair's terminal diagonal ``ln + lm`` get no recursion steps;
the kernels only zero-fill them, so the loop bound follows each pair's length.

On the CPU the same kernels run in the Pallas interpreter (tests); on a GPU
they compile through Triton; any other platform raises (:func:`interpret_mode`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from deepblast_jax.ops import smooth
from deepblast_jax.ops.dp_scan import MODE_BOUNDS

__all__ = [
    "forward",
    "forward_score",
    "backward",
    "adjoint_forward",
    "adjoint_backward",
    "interpret_mode",
    "lanes",
]

_RING_ROWS = 3


def interpret_mode(platform=None):
    """Whether the kernels run in the Pallas interpreter on ``platform``.

    The one place that decides it: ``cpu`` interprets (tests), ``gpu``
    compiles through Triton, and any other platform is an error -- a DP
    kernel never falls back to the interpreter on an accelerator."""
    platform = platform or jax.default_backend()
    if platform == "cpu":
        return True
    if platform == "gpu":
        return False
    raise NotImplementedError(
        f"the triton DP kernels run on 'gpu' (or interpreted on 'cpu'), "
        f"not on {platform!r}; use backend='scan'")


def lanes(N: int) -> int:
    """Lanes per program: slots ``1..N`` padded to a power of two."""
    return max(16, 1 << (max(N, 1) - 1).bit_length())


def _num_warps(P: int) -> int:
    return max(1, min(8, P // 128))


def _rem3(x):
    # ring row of diagonal x >= 0 (lax.rem: non-negative operands only)
    return lax.rem(x, jnp.int32(_RING_ROWS))


def _barrier(interpret):
    # the interpreter runs the lanes in lock step and has no lowering for
    # the GPU barrier; compiled, it orders the ring writes before re-reads
    if not interpret:
        plt.debug_barrier()


def _load(ref, offs, mask):
    if mask is None:
        return plt.load(ref.at[offs])
    return plt.load(ref.at[offs], mask=mask, other=0)


def _store(ref, offs, val, mask=None):
    plt.store(ref.at[offs], val, mask=mask)


def _ring_zero(ring_ref, b, P, dtype):
    zeros = jnp.zeros((2 * P,), dtype)
    for row in range(_RING_ROWS):
        _store(ring_ref, (b * _RING_ROWS + row) * 2 * P
               + jnp.arange(2 * P, dtype=jnp.int32), zeros)


def _zero_rows(refs, r0, K, B, N, b, P, dtype):
    """Zero rows ``[r0, K)`` of ``(K, B, N+1)`` outputs (no recursion)."""
    t = jnp.arange(P, dtype=jnp.int32)
    zeros = jnp.zeros((P,), dtype)

    def body(r, c):
        base = (r * B + b) * (N + 1)
        for ref in refs:
            _store(ref, base + t + 1, zeros, mask=t < N)
            ref[base] = jnp.zeros((), dtype)
        return c

    lax.fori_loop(r0, K, body, 0)


def _cell_masks(r, t, ln, lm, lo):
    i = t + 1
    j = r + 2 - i
    valid = (i >= lo) & (j >= lo) & (i <= ln) & (j <= lm)
    return i, valid


# ---------------------------------------------------------------------------
# forward (with or without residuals) and adjoint forward
# ---------------------------------------------------------------------------

def _forward_kernel(ln_ref, lm_ref, th_ref, a_ref, *refs, K, B, N, P, lo,
                    operator, residuals, interpret):
    if residuals:
        vt_ref, qx_ref, qm_ref, qy_ref, ring_ref = refs
    else:
        vt_ref, ring_ref = refs
    b = pl.program_id(0)
    ln = ln_ref[b]
    lm = lm_ref[b]
    dtype = vt_ref.dtype
    t = jnp.arange(P, dtype=jnp.int32)
    zero = jnp.zeros((), dtype)
    _ring_zero(ring_ref, b, P, dtype)
    _barrier(interpret)
    kend = jnp.minimum(ln + lm - 1, K)

    def body(r, c):
        i, valid = _cell_masks(r, t, ln, lm, lo)
        src = (r * B + b) * N + t
        th = _load(th_ref, src, valid)
        a = _load(a_ref, src, valid)
        row1 = (b * _RING_ROWS + _rem3(r + 2)) * 2 * P
        row2 = (b * _RING_ROWS + _rem3(r + 1)) * 2 * P
        v1_shr = _load(ring_ref, row1 + t, None)
        v1 = _load(ring_ref, row1 + t + 1, None)
        v2_shr = _load(ring_ref, row2 + t, None)
        val, (qx, qm, qy) = smooth.max3(operator, a + v1_shr, v2_shr, a + v1)
        vnew = jnp.where(valid, th + val, zero)
        _store(ring_ref, (b * _RING_ROWS + _rem3(r)) * 2 * P + t + 1,
               vnew)
        if residuals:
            dst = (r * B + b) * (N + 1)
            for ref, q in ((qx_ref, qx), (qm_ref, qm), (qy_ref, qy)):
                _store(ref, dst + i, jnp.where(valid, q, zero), mask=t < N)
                ref[dst] = zero
        _barrier(interpret)
        return c

    lax.fori_loop(0, kend, body, 0)
    last = (b * _RING_ROWS + _rem3(jnp.maximum(kend - 1, 0))) * 2 * P
    vt_ref[b] = jnp.where(kend >= 1, ring_ref[last + ln], zero)
    if residuals:
        _zero_rows((qx_ref, qm_ref, qy_ref), kend, K, B, N, b, P, dtype)


def _adjoint_forward_kernel(ln_ref, lm_ref, qx_ref, qm_ref, qy_ref, zt_ref,
                            *refs, K, B, N, P, lo, operator, has_za,
                            interpret):
    if has_za:
        za_ref, *refs = refs
    vtd_ref, qdx_ref, qdm_ref, qdy_ref, ring_ref = refs
    b = pl.program_id(0)
    ln = ln_ref[b]
    lm = lm_ref[b]
    dtype = vtd_ref.dtype
    t = jnp.arange(P, dtype=jnp.int32)
    zero = jnp.zeros((), dtype)
    _ring_zero(ring_ref, b, P, dtype)
    _barrier(interpret)
    kend = jnp.minimum(ln + lm - 1, K)

    def body(r, c):
        i, valid = _cell_masks(r, t, ln, lm, lo)
        src = (r * B + b) * N + t
        zt = _load(zt_ref, src, valid)
        za = _load(za_ref, src, valid) if has_za else zero
        res = (r * B + b) * (N + 1) + i
        qx = _load(qx_ref, res, valid)
        qm = _load(qm_ref, res, valid)
        qy = _load(qy_ref, res, valid)
        row1 = (b * _RING_ROWS + _rem3(r + 2)) * 2 * P
        row2 = (b * _RING_ROWS + _rem3(r + 1)) * 2 * P
        xargd = za + _load(ring_ref, row1 + t, None)
        margd = _load(ring_ref, row2 + t, None)
        yargd = za + _load(ring_ref, row1 + t + 1, None)
        vdnew = zt + qx * xargd + qm * margd + qy * yargd
        qdx, qdm, qdy = smooth.hessian3(operator, (qx, qm, qy),
                                        (xargd, margd, yargd))
        vdnew = jnp.where(valid, vdnew, zero)
        _store(ring_ref, (b * _RING_ROWS + _rem3(r)) * 2 * P + t + 1,
               vdnew)
        dst = (r * B + b) * (N + 1)
        for ref, q in ((qdx_ref, qdx), (qdm_ref, qdm), (qdy_ref, qdy)):
            _store(ref, dst + i, jnp.where(valid, q, zero), mask=t < N)
            ref[dst] = zero
        _barrier(interpret)
        return c

    lax.fori_loop(0, kend, body, 0)
    last = (b * _RING_ROWS + _rem3(jnp.maximum(kend - 1, 0))) * 2 * P
    vtd_ref[b] = jnp.where(kend >= 1, ring_ref[last + ln], zero)
    _zero_rows((qdx_ref, qdm_ref, qdy_ref), kend, K, B, N, b, P, dtype)


# ---------------------------------------------------------------------------
# backward and adjoint backward (reverse loops)
# ---------------------------------------------------------------------------

def _backward_kernel(ln_ref, lm_ref, et_ref, qx_ref, qm_ref, qy_ref,
                     e_ref, ring_ref, *, K, B, N, P, lo, interpret):
    b = pl.program_id(0)
    ln = ln_ref[b]
    lm = lm_ref[b]
    et = et_ref[b]
    dtype = e_ref.dtype
    t = jnp.arange(P, dtype=jnp.int32)
    zero = jnp.zeros((), dtype)
    _ring_zero(ring_ref, b, P, dtype)
    _barrier(interpret)
    kend = jnp.minimum(ln + lm - 1, K)

    def body(s, c):
        r = kend - 1 - s
        i, valid = _cell_masks(r, t, ln, lm, lo)
        up = (i + 1 <= N)
        row1 = ((r + 1) * B + b) * (N + 1)
        row2 = ((r + 2) * B + b) * (N + 1)
        in1 = r + 1 < K
        in2 = r + 2 < K
        q1x = _load(qx_ref, row1 + i + 1, up & in1)
        q1y = _load(qy_ref, row1 + i, (t < N) & in1)
        q2m = _load(qm_ref, row2 + i + 1, up & in2)
        ring1 = (b * _RING_ROWS + _rem3(r + 1)) * 2 * P
        ring2 = (b * _RING_ROWS + _rem3(r + 2)) * 2 * P
        e1 = _load(ring_ref, ring1 + i, None)
        e1s = _load(ring_ref, ring1 + i + 1, None)
        e2s = _load(ring_ref, ring2 + i + 1, None)
        enew = jnp.where(valid, q1x * e1s + q2m * e2s + q1y * e1, zero)
        seed = (i == ln) & (r + 2 == ln + lm)
        enew = enew + jnp.where(seed, et, zero)
        _store(ring_ref, (b * _RING_ROWS + _rem3(r)) * 2 * P + i, enew)
        dst = (r * B + b) * (N + 1)
        _store(e_ref, dst + i, enew, mask=t < N)
        e_ref[dst] = zero
        _barrier(interpret)
        return c

    lax.fori_loop(0, kend, body, 0)
    _zero_rows((e_ref,), kend, K, B, N, b, P, dtype)


def _adjoint_backward_kernel(ln_ref, lm_ref, e_ref, qx_ref, qm_ref, qy_ref,
                             qdx_ref, qdm_ref, qdy_ref, ed_ref, ring_ref, *,
                             K, B, N, P, lo, interpret):
    b = pl.program_id(0)
    ln = ln_ref[b]
    lm = lm_ref[b]
    dtype = ed_ref.dtype
    t = jnp.arange(P, dtype=jnp.int32)
    zero = jnp.zeros((), dtype)
    _ring_zero(ring_ref, b, P, dtype)
    _barrier(interpret)
    kend = jnp.minimum(ln + lm - 1, K)

    def body(s, c):
        r = kend - 1 - s
        i, valid = _cell_masks(r, t, ln, lm, lo)
        up = (i + 1 <= N)
        row1 = ((r + 1) * B + b) * (N + 1)
        row2 = ((r + 2) * B + b) * (N + 1)
        m1s = up & (r + 1 < K)
        m1 = (t < N) & (r + 1 < K)
        m2s = up & (r + 2 < K)
        ring1 = (b * _RING_ROWS + _rem3(r + 1)) * 2 * P
        ring2 = (b * _RING_ROWS + _rem3(r + 2)) * 2 * P
        x_term = (_load(qdx_ref, row1 + i + 1, m1s)
                  * _load(e_ref, row1 + i + 1, m1s)
                  + _load(qx_ref, row1 + i + 1, m1s)
                  * _load(ring_ref, ring1 + i + 1, None))
        m_term = (_load(qdm_ref, row2 + i + 1, m2s)
                  * _load(e_ref, row2 + i + 1, m2s)
                  + _load(qm_ref, row2 + i + 1, m2s)
                  * _load(ring_ref, ring2 + i + 1, None))
        y_term = (_load(qdy_ref, row1 + i, m1) * _load(e_ref, row1 + i, m1)
                  + _load(qy_ref, row1 + i, m1)
                  * _load(ring_ref, ring1 + i, None))
        ednew = jnp.where(valid, x_term + m_term + y_term, zero)
        _store(ring_ref, (b * _RING_ROWS + _rem3(r)) * 2 * P + i, ednew)
        dst = (r * B + b) * (N + 1)
        _store(ed_ref, dst + i, ednew, mask=t < N)
        ed_ref[dst] = zero
        _barrier(interpret)
        return c

    lax.fori_loop(0, kend, body, 0)
    _zero_rows((ed_ref,), kend, K, B, N, b, P, dtype)


# ---------------------------------------------------------------------------
# wrappers: the dp_scan pass signatures
# ---------------------------------------------------------------------------

def _check_size(K, B, N):
    if K * B * (N + 1) >= 2 ** 31:
        raise ValueError(
            f"DP stream of {K}x{B}x{N + 1} cells exceeds int32 offsets; "
            "split the batch")


def _run(kernel, name, inputs, out_shapes, *, B, P, **static):
    interpret = interpret_mode()
    flat_in = [x.reshape(-1) if x.ndim > 1 else x for x in inputs]
    ring = jax.ShapeDtypeStruct((B * _RING_ROWS * 2 * P,),
                                out_shapes[0].dtype)
    outs = pl.pallas_call(
        functools.partial(kernel, B=B, P=P, interpret=interpret, **static),
        out_shape=[*out_shapes, ring],
        grid=(B,),
        interpret=interpret,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=_num_warps(P),
                                           num_stages=1),
        name=name,
    )(*flat_in)
    return outs[:-1]


def _lengths(ln, lm):
    return ln.astype(jnp.int32), lm.astype(jnp.int32)


def _stream_shape(K, B, N, dtype):
    return jax.ShapeDtypeStruct((K * B * (N + 1),), dtype)


def forward(thetad, Ad, ln, lm, *, mode="nw", operator="softmax"):
    """:func:`dp_scan.forward_scan` as one kernel: ``(vt, (qx, qm, qy))``."""
    K, B, N = thetad.shape
    _check_size(K, B, N)
    dt = thetad.dtype
    vt, qx, qm, qy = _run(
        _forward_kernel, "dp_forward", [*_lengths(ln, lm), thetad, Ad],
        [jax.ShapeDtypeStruct((B,), dt)] + [_stream_shape(K, B, N, dt)] * 3,
        B=B, P=lanes(N), K=K, N=N, lo=MODE_BOUNDS[mode][0],
        operator=operator, residuals=True)
    shape = (K, B, N + 1)
    return vt, (qx.reshape(shape), qm.reshape(shape), qy.reshape(shape))


def forward_score(thetad, Ad, ln, lm, *, mode="nw", operator="softmax"):
    """Terminal scores only: the forward kernel without residual writes."""
    K, B, N = thetad.shape
    _check_size(K, B, N)
    (vt,) = _run(
        _forward_kernel, "dp_forward_score", [*_lengths(ln, lm), thetad, Ad],
        [jax.ShapeDtypeStruct((B,), thetad.dtype)],
        B=B, P=lanes(N), K=K, N=N, lo=MODE_BOUNDS[mode][0],
        operator=operator, residuals=False)
    return vt


def backward(Et, qs, ln, lm, *, mode="nw"):
    """:func:`dp_scan.backward_scan` as one kernel: ``E`` (K, B, N+1)."""
    qx, qm, qy = qs
    K, B, L = qx.shape
    N = L - 1
    _check_size(K, B, N)
    (E,) = _run(
        _backward_kernel, "dp_backward",
        [*_lengths(ln, lm), Et.astype(qx.dtype), qx, qm, qy],
        [_stream_shape(K, B, N, qx.dtype)],
        B=B, P=lanes(N), K=K, N=N, lo=MODE_BOUNDS[mode][1])
    return E.reshape(K, B, L)


def adjoint_forward(qs, Ztd, ZAd, ln, lm, *, mode="nw", operator="softmax"):
    """:func:`dp_scan.adjoint_forward_scan` as one kernel.  ``ZAd=None``
    means a zero gap tangent and drops that input stream."""
    qx, qm, qy = qs
    K, B, N = Ztd.shape
    _check_size(K, B, N)
    dt = Ztd.dtype
    inputs = [*_lengths(ln, lm), qx, qm, qy, Ztd]
    if ZAd is not None:
        inputs.append(ZAd)
    vtd, qdx, qdm, qdy = _run(
        _adjoint_forward_kernel, "dp_adjoint_forward", inputs,
        [jax.ShapeDtypeStruct((B,), dt)] + [_stream_shape(K, B, N, dt)] * 3,
        B=B, P=lanes(N), K=K, N=N, lo=MODE_BOUNDS[mode][2],
        operator=operator, has_za=ZAd is not None)
    shape = (K, B, N + 1)
    return vtd, (qdx.reshape(shape), qdm.reshape(shape), qdy.reshape(shape))


def adjoint_backward(Ediag, qs, qds, ln, lm, *, mode="nw"):
    """:func:`dp_scan.adjoint_backward_scan` as one kernel: ``Ed``."""
    K, B, L = Ediag.shape
    N = L - 1
    _check_size(K, B, N)
    (Ed,) = _run(
        _adjoint_backward_kernel, "dp_adjoint_backward",
        [*_lengths(ln, lm), Ediag, *qs, *qds],
        [_stream_shape(K, B, N, Ediag.dtype)],
        B=B, P=lanes(N), K=K, N=N, lo=MODE_BOUNDS[mode][3])
    return Ed.reshape(K, B, L)
