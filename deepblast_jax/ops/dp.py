"""Differentiable smoothed alignment DP — public API and autodiff wiring.

This module replaces the reference's paired ``torch.autograd.Function``
machinery (reference: deepblast/nw.py:315-386, deepblast/nw_cuda.py:168-262)
with two nested :func:`jax.custom_vjp` functions:

``alignment_score(theta, A, lengths) -> Vt``
    The terminal smoothed alignment score.  Its VJP *is* the expected
    alignment — the posterior marginal matrix ``E`` — computed by the reverse
    DP pass.

``expected_alignment(theta, A, lengths, Et) -> (E_theta, E_A)``
    The gradient map itself, exposed as a first-class differentiable
    function (this is ``decode`` in the reference,
    deepblast/nw.py:446-458).  Its VJP uses the symmetry of the Hessian of
    ``Vt``: the VJP of a gradient map equals its JVP, which the adjoint
    (directional-derivative) passes compute — exactly the trick behind the
    reference's ``NeedlemanWunschFunctionBackward`` (deepblast/nw.py:342-386,
    after Mensch & Blondel 2018).  ``jax.grad`` therefore composes twice,
    which training requires (the loss differentiates through ``decode``).

Deviations from the reference (documented, intentional):

* The gap potential receives its *correct* gradient
  ``dVt/dA[i-1,j-1] = E[i,j] * (Qx[i,j] + Qy[i,j])``.  The reference returns
  the tensor ``A`` itself as its own gradient (deepblast/nw.py:337-339) and
  then discards it, so its gap head trains with zero gradient.
* The gap matrix is indexed per-cell ``A[i-1, j-1]`` (the reference CPU
  semantics, deepblast/nw.py:56-58) — not the CUDA rolling-row bug
  (deepblast/nw_cuda.py:61-63).
* Batches carry explicit per-pair lengths instead of per-pair Python slicing
  (reference: deepblast/alignment.py:165-169), keeping XLA shapes static.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from deepblast_jax import native
from deepblast_jax.ops import dp_scan, dp_triton
from deepblast_jax.ops.skew import skew, unskew

__all__ = [
    "alignment_score",
    "expected_alignment",
    "expected_alignment_stream",
    "traceback",
    "traceback_stream",
    "AlignmentDecoder",
    "NeedlemanWunschDecoder",
    "SmithWatermanDecoder",
    "get_backend",
    "platform_default_backend",
    "register_backend",
    "set_default_backend",
    "stream_affine",
]


# ---------------------------------------------------------------------------
# Backend registry: each backend provides the four passes over the skew
# layout of ops/skew.py behind one residual interface (the ``aux`` that
# ``forward`` returns is the soft-argmax diagonals ``(qx, qm, qy)``, each
# (K, B, N+1), which every backend reads and writes in the same layout):
#
#   forward(th_s, A_s, ln, lm, mode=, operator=) -> (vt, aux)
#   forward_score(th_s, A_s, ln, lm, mode=, operator=) -> vt   [optional]
#   backward(Et, aux, ln, lm, mode=, want_gap=)
#       -> (E_s, EA_s | None)            with EA = E * (Qx + Qy)
#   adjoint_forward(aux, Zt_s, Za_s, ln, lm, mode=, operator=)
#       -> (vtd, adj_aux)                Za_s None: zero gap tangent
#   adjoint_backward(E_s, aux, adj_aux, ln, lm, mode=)
#       -> (Ed_s, EdA_s)   with EdA = Ed * (Qx + Qy) + E * (Qdx + Qdy)
#
# "scan" is the portable lax.scan implementation (the oracle); "triton" runs
# each pass as one Pallas kernel on the GPU (deepblast_jax.ops.dp_triton).
# ---------------------------------------------------------------------------

def _xla_unskew(s, N, M, B):
    return unskew(s, N, M, offset=1)[:B]


def _gap_mul(E_s, aux_x, aux_y):
    return E_s * (aux_x + aux_y)


def _with_gap(backward):
    def run(Et, aux, ln, lm, *, mode, want_gap):
        E = backward(Et, aux, ln, lm, mode=mode)
        EA = _gap_mul(E, aux[0], aux[2]) if want_gap else None
        return E, EA
    return run


def _with_gap_adjoint(adjoint_backward):
    def run(E_s, aux, adj_aux, ln, lm, *, mode):
        Ed = adjoint_backward(E_s, aux, adj_aux, ln, lm, mode=mode)
        EdA = _gap_mul(Ed, aux[0], aux[2]) + _gap_mul(E_s, adj_aux[0],
                                                      adj_aux[2])
        return Ed, EdA
    return run


def stream_affine(s, b):
    """Affine view of the E stream for the native C walk: cell (i, j) of
    pair b lives at s[i+j, b, i+1], flat offset
    (i+j)*B*S + b*S + (i+1) = i*(B*S+1) + j*B*S + (b*S+1)."""
    return (np.ascontiguousarray(s).reshape(-1)[b * s.shape[2] + 1:],
            s.shape[1] * s.shape[2] + 1, s.shape[1] * s.shape[2])


_BACKENDS = {
    "scan": {
        "forward": dp_scan.forward_scan,
        "backward": _with_gap(dp_scan.backward_scan),
        "adjoint_forward": dp_scan.adjoint_forward_scan,
        "adjoint_backward": _with_gap_adjoint(dp_scan.adjoint_backward_scan),
    },
    "triton": {
        "forward": dp_triton.forward,
        "forward_score": dp_triton.forward_score,
        "backward": _with_gap(dp_triton.backward),
        "adjoint_forward": dp_triton.adjoint_forward,
        "adjoint_backward": _with_gap_adjoint(dp_triton.adjoint_backward),
    },
}

# explicit default set by set_default_backend / register_backend; None
# means the platform decides (platform_default_backend)
_DEFAULT_BACKEND = [None]


def platform_default_backend(platform=None):
    """The DP backend a call without ``backend=`` gets: the Triton kernels
    on a GPU, the scan oracle anywhere else.  The one place that decides."""
    platform = platform or jax.default_backend()
    return "triton" if platform == "gpu" else "scan"


def register_backend(name, fns, make_default=False):
    _BACKENDS[name] = fns
    if make_default:
        _DEFAULT_BACKEND[0] = name


def get_backend(name=None):
    if name is None:
        name = _DEFAULT_BACKEND[0] or platform_default_backend()
    if name not in _BACKENDS:
        raise ValueError(f"unknown DP backend {name!r}; "
                         f"choose from {sorted(_BACKENDS)}")
    return name, _BACKENDS[name]


def set_default_backend(name):
    """Route calls without ``backend=`` to ``name`` (None: the platform
    decides again)."""
    if name is not None and name not in _BACKENDS:
        raise ValueError(f"unknown DP backend {name!r}")
    _DEFAULT_BACKEND[0] = name


def _per_shard(fn, out_specs=P("data")):
    """``fn`` run on each device's share of the batch when the context mesh
    (``jax.set_mesh``) splits it over a ``data`` axis of several devices.

    Every pair's DP is independent.  The kernels are custom calls that XLA's
    partitioner cannot split, so without this each device would gather the
    whole batch and run all of its DP.  ``fn`` takes batch-leading arrays.
    ``check_vma=False``: pallas_call states no varying mesh axes for its
    outputs, and its interpreter does not track them."""
    mesh = jax.sharding.get_abstract_mesh()
    if mesh.empty or dict(mesh.shape).get("data", 1) == 1:
        return fn
    return jax.shard_map(fn, mesh=mesh, in_specs=P("data"),
                         out_specs=out_specs, check_vma=False)


# ---------------------------------------------------------------------------
# custom_vjp construction (cached per static configuration)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _build(mode: str, operator: str, backend: str, with_gap: bool = True):
    be = _BACKENDS[backend]

    def _skewed(theta, A):
        return skew(theta), skew(A)

    def _run_forward(theta, A, ln, lm):
        thetad, Ad = _skewed(theta, A)
        return be["forward"](thetad, Ad, ln, lm, mode=mode, operator=operator)

    # -- level 2: the expected-alignment (gradient) map --------------------
    # ``with_gap`` also emits E_A = dVt/dA; the decode hot path skips it
    # (it is pure extra memory traffic when only the alignment is consumed).
    @jax.custom_vjp
    def expected(theta, A, Et, lnf, lmf):
        out, _ = _expected_fwd(theta, A, Et, lnf, lmf)
        return out

    def _expected_fwd(theta, A, Et, lnf, lmf):
        B, N, M = theta.shape
        ln = lnf.astype(jnp.int32)
        lm = lmf.astype(jnp.int32)
        _, aux = _run_forward(theta, A, ln, lm)
        Ediag, EAdiag = be["backward"](Et, aux, ln, lm, mode=mode,
                                       want_gap=with_gap)
        E_theta = _xla_unskew(Ediag, N, M, B)
        if with_gap:
            out = (E_theta, _xla_unskew(EAdiag, N, M, B))
        else:
            out = E_theta
        return out, (aux, Ediag, Et, lnf, lmf)

    def _expected_bwd(res, cts):
        aux, Ediag, Et, lnf, lmf = res
        if with_gap:
            Zt, Za = cts
        else:
            Zt, Za = cts, None
        B, N, M = Zt.shape
        ln = lnf.astype(jnp.int32)
        lm = lmf.astype(jnp.int32)
        Ztd = skew(Zt)
        # with_gap=False (the training decode path): the gap cotangent is
        # identically zero and the backends drop that input stream instead
        # of reading a zeros tensor
        ZAd = None if Za is None else skew(Za)
        # Hessian symmetry: VJP of the gradient map == JVP along (Zt, Za).
        vtd, adj_aux = be["adjoint_forward"](
            aux, Ztd, ZAd, ln, lm, mode=mode, operator=operator)
        Eddiag, EdAdiag = be["adjoint_backward"](
            Ediag, aux, adj_aux, ln, lm, mode=mode)
        g_theta = _xla_unskew(Eddiag, N, M, B)
        g_A = _xla_unskew(EdAdiag, N, M, B)
        # E is linear in Et, so d<cts, E>/dEt = <cts, E>/Et = vtd (the
        # adjoint-forward terminal tangent is Et-free).
        return (g_theta, g_A, vtd,
                jnp.zeros_like(lnf), jnp.zeros_like(lmf))

    expected.defvjp(_expected_fwd, _expected_bwd)

    # -- level 1: the terminal score ---------------------------------------
    @jax.custom_vjp
    def score(theta, A, lnf, lmf):
        ln = lnf.astype(jnp.int32)
        lm = lmf.astype(jnp.int32)
        if "forward_score" in be:
            # score-only kernel: no residual writes.  Safe here because
            # this primal has no reverse consumer -- when score IS
            # differentiated, _score_bwd recomputes through `expected`
            # (whose forward writes the residuals).
            thetad, Ad = _skewed(theta, A)
            return be["forward_score"](thetad, Ad, ln, lm, mode=mode,
                                       operator=operator)
        vt, _ = _run_forward(theta, A, ln, lm)
        return vt

    def _score_fwd(theta, A, lnf, lmf):
        return score(theta, A, lnf, lmf), (theta, A, lnf, lmf)

    def _score_bwd(res, Et):
        theta, A, lnf, lmf = res
        g_theta, g_A = expected(theta, A, Et, lnf, lmf)
        return (g_theta, g_A, jnp.zeros_like(lnf), jnp.zeros_like(lmf))

    score.defvjp(_score_fwd, _score_bwd)

    return score, expected


def _lengths(theta, lengths):
    B, N, M = theta.shape
    if lengths is None:
        ln = jnp.full((B,), N, theta.dtype)
        lm = jnp.full((B,), M, theta.dtype)
    else:
        ln, lm = lengths
        ln = jnp.asarray(ln).astype(theta.dtype)
        lm = jnp.asarray(lm).astype(theta.dtype)
    return ln, lm


def alignment_score(theta, A, lengths=None, *, mode="nw",
                    operator="softmax", backend=None):
    """Terminal smoothed alignment score ``Vt`` for a padded batch.

    Parameters
    ----------
    theta : (B, N, M) match potentials.
    A : (B, N, M) per-cell gap potentials.
    lengths : optional tuple of (B,) arrays ``(ln, lm)`` of true lengths.
    backend : DP backend name; None lets the platform decide.
    """
    backend, _ = get_backend(backend)
    score, _ = _build(mode, operator, backend, True)
    ln, lm = _lengths(theta, lengths)
    return _per_shard(score)(theta, A, ln, lm)


def expected_alignment(theta, A, lengths=None, Et=None, *, mode="nw",
                       operator="softmax", backend=None, return_gap=False):
    """Expected (posterior marginal) alignment matrix — ``decode``.

    Differentiable (twice) w.r.t. ``theta`` and ``A``.  With
    ``return_gap=True`` also returns the expected gap-potential usage
    ``E_A = dVt/dA``.
    """
    backend, _ = get_backend(backend)
    _, expected = _build(mode, operator, backend, bool(return_gap))
    ln, lm = _lengths(theta, lengths)
    if Et is None:
        Et = jnp.ones((theta.shape[0],), theta.dtype)
    return _per_shard(expected)(theta, A, Et, ln, lm)


def expected_alignment_stream(theta, A, lengths=None, Et=None, *, mode="nw",
                              operator="softmax", backend=None):
    """Expected alignment in the diagonal stream layout — the
    inference/traceback hot path.

    Skips the unskew relayout: :func:`traceback_stream` walks the stream
    directly on host, so nothing in the inference path needs the natural
    ``(B, N, M)`` form.  Inference-only: NOT differentiable (the
    custom_vjp wiring lives on :func:`expected_alignment`)."""
    _, be = get_backend(backend)
    ln, lm = _lengths(theta, lengths)
    if Et is None:
        Et = jnp.ones((theta.shape[0],), theta.dtype)

    def decode(theta, A, Et, ln, lm):
        ln = ln.astype(jnp.int32)
        lm = lm.astype(jnp.int32)
        _, aux = be["forward"](skew(theta), skew(A), ln, lm, mode=mode,
                               operator=operator)
        Ediag, _ = be["backward"](Et, aux, ln, lm, mode=mode,
                                  want_gap=False)
        return Ediag

    return _per_shard(decode, P(None, "data"))(theta, A, Et, ln, lm)


# ---------------------------------------------------------------------------
# Traceback (host-side greedy walk; reference: deepblast/nw.py:401-444)
# ---------------------------------------------------------------------------

def traceback(grad):
    """Greedy argmax walk over an expected-alignment matrix.

    ``grad`` is a single pair's (N, M) matrix (numpy or jax array), already
    sliced to true lengths.  Returns a list of ``(i, j, state)`` tuples with
    states (x, m, y) = (0, 1, 2), identical to the reference walk including
    its tie-breaking order (left, diag, up) and trailing-gap padding.

    Documented deviation: the diagonal move is disabled when *either* index
    is at the border.  The reference guards it with ``i <= 0 and j <= 0``
    (deepblast/nw.py:423), so at ``i == 0, j > 0`` it reads
    ``grad[-1, j-1]`` — the tensor wraps to the *last* row and the walk can
    leave the matrix (observable on the reference's own ``dm.txt`` fixture,
    whose test is CUDA-gated and never ran: tests/test_nw_cuda.py:79-89).
    """
    grad = np.ascontiguousarray(np.asarray(grad))
    if grad.dtype in (np.float32, np.float64):
        states = native.traceback_affine(grad, grad.shape[1], 1,
                                         grad.shape[0], grad.shape[1])
        if states is not None:
            return states
    return _traceback_walk(lambda i, j: grad[i, j], *grad.shape)


def _traceback_walk(get, N, M):
    """The greedy walk itself, over a cell accessor ``get(i, j)`` — shared
    by the natural-layout and stream-layout entry points."""
    m, x, y = 1, 0, 2
    i, j = N - 1, M - 1
    states = [(i, j, m)]
    neg = -100000.0
    while True:
        left = neg if i <= 0 else get(i - 1, j)
        diag = neg if (i <= 0 or j <= 0) else get(i - 1, j - 1)
        upper = neg if j <= 0 else get(i, j - 1)
        if left == neg and diag == neg and upper == neg:
            break
        ij = int(np.argmax([left, diag, upper]))
        if ij == 0:
            i, s = i - 1, x
        elif ij == 1:
            i, j, s = i - 1, j - 1, m
        else:
            j, s = j - 1, y
        states.append((i, j, s))
    while i > 0:
        i -= 1
        states.append((i, j, x))
    while j > 0:
        j -= 1
        states.append((i, j, y))
    return states[::-1]


def traceback_stream(stream, n, m, b=0):
    """Greedy traceback directly from an expected-alignment stream
    (:func:`expected_alignment_stream`), for pair ``b`` with true lengths
    ``(n, m)``.  The walk touches O(n+m) cells, so the layout remap happens
    per visited cell on host — no device-side unskew.  Identical output to
    ``traceback(unskew(stream)[b, :n, :m])`` (test-covered)."""
    stream = np.asarray(stream)
    if stream.dtype in (np.float32, np.float64):
        flat, si, sj = stream_affine(stream, b)
        states = native.traceback_affine(flat, si, sj, n, m)
        if states is not None:
            return states
    # s[d, b, i] holds cell (i-1, d-i+1): cell (i, j) -> s[i+j, b, i+1]
    return _traceback_walk(lambda i, j: float(stream[i + j, b, i + 1]),
                           n, m)


# ---------------------------------------------------------------------------
# Decoder façade mirroring the reference nn.Module API
# (reference: deepblast/nw.py:389-458, deepblast/sw.py:316-384)
# ---------------------------------------------------------------------------

class AlignmentDecoder:
    """Callable façade bundling score / decode / traceback for one mode."""

    mode = "nw"

    def __init__(self, operator="softmax", backend=None):
        self.operator = operator
        self.backend = backend

    def __call__(self, theta, A, lengths=None):
        return alignment_score(theta, A, lengths, mode=self.mode,
                               operator=self.operator, backend=self.backend)

    forward = __call__

    def decode(self, theta, A, lengths=None, Et=None, return_gap=False):
        return expected_alignment(theta, A, lengths, Et, mode=self.mode,
                                  operator=self.operator,
                                  backend=self.backend,
                                  return_gap=return_gap)

    @staticmethod
    def traceback(grad):
        return traceback(grad)


class NeedlemanWunschDecoder(AlignmentDecoder):
    mode = "nw"


class SmithWatermanDecoder(AlignmentDecoder):
    mode = "sw"
