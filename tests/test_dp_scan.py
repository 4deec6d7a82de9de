"""Wavefront scan passes vs. the plain-numpy ground-truth DP.

Oracle strategy mirrors the reference test suite's use of
``torch.autograd.gradcheck`` against the custom Functions
(reference: deepblast/tests/test_nw.py:57-79): here the load-bearing oracles
are (a) the direct numpy loop implementation and (b) JAX autodiff through the
scan forward pass, which must agree with the hand-written backward/adjoint
passes wired through custom_vjp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepblast_jax.ops import dp as dp_mod
from deepblast_jax.ops import dp_scan, reference_dp
from deepblast_jax.ops.skew import skew, unskew


def _random_problem(rng, B, N, M, varlen=True):
    theta = rng.standard_normal((B, N, M))
    A = rng.standard_normal((B, N, M)) * 0.5 - 1.0
    if varlen:
        ln = rng.integers(3, N + 1, size=B)
        lm = rng.integers(3, M + 1, size=B)
        ln[0], lm[0] = N, M
    else:
        ln = np.full(B, N)
        lm = np.full(B, M)
    return theta, A, ln, lm


MODES = ["nw", "sw"]
OPERATORS = ["softmax", "sparsemax", "hardmax"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("operator", OPERATORS)
def test_forward_matches_numpy(mode, operator):
    rng = np.random.default_rng(0)
    B, N, M = 3, 7, 5
    theta, A, ln, lm = _random_problem(rng, B, N, M)
    vt, qs = dp_scan.forward_scan(
        skew(jnp.asarray(theta)), skew(jnp.asarray(A)),
        jnp.asarray(ln), jnp.asarray(lm), mode=mode, operator=operator)
    Qx = np.asarray(unskew(qs[0], N, M, offset=1))
    Qm = np.asarray(unskew(qs[1], N, M, offset=1))
    Qy = np.asarray(unskew(qs[2], N, M, offset=1))
    for b in range(B):
        n, m = int(ln[b]), int(lm[b])
        vt_ref, _, Q_ref = reference_dp.forward(
            theta[b, :n, :m], A[b, :n, :m], mode=mode, operator=operator)
        np.testing.assert_allclose(vt[b], vt_ref, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(
            Qx[b, :n, :m], Q_ref[1:n + 1, 1:m + 1, 0], atol=1e-10)
        np.testing.assert_allclose(
            Qm[b, :n, :m], Q_ref[1:n + 1, 1:m + 1, 1], atol=1e-10)
        np.testing.assert_allclose(
            Qy[b, :n, :m], Q_ref[1:n + 1, 1:m + 1, 2], atol=1e-10)
        # padding region must be exactly zero
        assert np.all(Qx[b, n:, :] == 0) and np.all(Qx[b, :, m:] == 0)


@pytest.mark.parametrize("mode", MODES)
def test_backward_matches_numpy(mode):
    rng = np.random.default_rng(1)
    B, N, M = 3, 6, 8
    theta, A, ln, lm = _random_problem(rng, B, N, M)
    Et = rng.standard_normal(B)
    lnj, lmj = jnp.asarray(ln), jnp.asarray(lm)
    _, qs = dp_scan.forward_scan(
        skew(jnp.asarray(theta)), skew(jnp.asarray(A)), lnj, lmj, mode=mode)
    Ediag = dp_scan.backward_scan(jnp.asarray(Et), qs, lnj, lmj, mode=mode)
    E = np.asarray(unskew(Ediag, N, M, offset=1))
    for b in range(B):
        n, m = int(ln[b]), int(lm[b])
        _, _, Q_ref = reference_dp.forward(
            theta[b, :n, :m], A[b, :n, :m], mode=mode)
        E_ref = reference_dp.backward(Et[b], Q_ref, mode=mode)
        np.testing.assert_allclose(
            E[b, :n, :m], E_ref[1:n + 1, 1:m + 1], atol=1e-9)
        assert np.all(E[b, n:, :] == 0) and np.all(E[b, :, m:] == 0)


@pytest.mark.parametrize("mode", MODES)
def test_adjoint_matches_numpy(mode):
    rng = np.random.default_rng(2)
    B, N, M = 2, 5, 6
    theta, A, ln, lm = _random_problem(rng, B, N, M)
    Zt = rng.standard_normal((B, N, M))
    ZA = rng.standard_normal((B, N, M))
    Et = np.ones(B)
    lnj, lmj = jnp.asarray(ln), jnp.asarray(lm)
    _, qs = dp_scan.forward_scan(
        skew(jnp.asarray(theta)), skew(jnp.asarray(A)), lnj, lmj, mode=mode)
    Ediag = dp_scan.backward_scan(jnp.asarray(Et), qs, lnj, lmj, mode=mode)
    vtd, qds = dp_scan.adjoint_forward_scan(
        qs, skew(jnp.asarray(Zt)), skew(jnp.asarray(ZA)), lnj, lmj, mode=mode)
    Eddiag = dp_scan.adjoint_backward_scan(Ediag, qs, qds, lnj, lmj, mode=mode)
    Ed = np.asarray(unskew(Eddiag, N, M, offset=1))
    Qdx = np.asarray(unskew(qds[0], N, M, offset=1))
    for b in range(B):
        n, m = int(ln[b]), int(lm[b])
        _, _, Q_ref = reference_dp.forward(
            theta[b, :n, :m], A[b, :n, :m], mode=mode)
        E_ref = reference_dp.backward(Et[b], Q_ref, mode=mode)
        vtd_ref, _, Qd_ref = reference_dp.adjoint_forward(
            Q_ref, Zt[b, :n, :m], ZA[b, :n, :m], mode=mode)
        Ed_ref = reference_dp.adjoint_backward(E_ref, Q_ref, Qd_ref, mode=mode)
        np.testing.assert_allclose(vtd[b], vtd_ref, atol=1e-9)
        np.testing.assert_allclose(
            Qdx[b, :n, :m], Qd_ref[1:n + 1, 1:m + 1, 0], atol=1e-9)
        np.testing.assert_allclose(
            Ed[b, :n, :m], Ed_ref[1:n + 1, 1:m + 1], atol=1e-9)


@pytest.mark.parametrize("mode", MODES)
def test_custom_vjp_first_order_vs_autodiff(mode):
    """grad of alignment_score (custom backward pass) == grad through the
    scan via plain JAX AD, for both theta and the gap matrix A."""
    rng = np.random.default_rng(3)
    B, N, M = 2, 6, 5
    theta, A, ln, lm = _random_problem(rng, B, N, M)
    theta, A = jnp.asarray(theta), jnp.asarray(A)
    lnj, lmj = jnp.asarray(ln), jnp.asarray(lm)

    def score_ad(theta, A):
        vt, _ = dp_scan.forward_scan(skew(theta), skew(A), lnj, lmj, mode=mode)
        return vt.sum()

    def score_custom(theta, A):
        return dp_mod.alignment_score(
            theta, A, (lnj, lmj), mode=mode).sum()

    np.testing.assert_allclose(score_ad(theta, A), score_custom(theta, A),
                               rtol=1e-12)
    g_ad = jax.grad(score_ad, argnums=(0, 1))(theta, A)
    g_c = jax.grad(score_custom, argnums=(0, 1))(theta, A)
    np.testing.assert_allclose(g_c[0], g_ad[0], atol=1e-9)
    np.testing.assert_allclose(g_c[1], g_ad[1], atol=1e-9)


@pytest.mark.parametrize("mode", MODES)
def test_expected_alignment_is_score_gradient(mode):
    rng = np.random.default_rng(4)
    B, N, M = 2, 5, 7
    theta, A, ln, lm = _random_problem(rng, B, N, M)
    theta, A = jnp.asarray(theta), jnp.asarray(A)
    lnj, lmj = jnp.asarray(ln), jnp.asarray(lm)
    E, EA = dp_mod.expected_alignment(
        theta, A, (lnj, lmj), mode=mode, return_gap=True)
    g = jax.grad(
        lambda t, a: dp_mod.alignment_score(t, a, (lnj, lmj), mode=mode).sum(),
        argnums=(0, 1))(theta, A)
    np.testing.assert_allclose(E, g[0], atol=1e-10)
    np.testing.assert_allclose(EA, g[1], atol=1e-10)


@pytest.mark.parametrize("mode", MODES)
def test_second_order_vs_double_autodiff(mode):
    """The Hessian-symmetry custom second-order path must agree with plain
    JAX double-AD through the scans (the analogue of gradgradcheck,
    reference: deepblast/tests/test_nw.py:69-79)."""
    rng = np.random.default_rng(5)
    B, N, M = 2, 4, 5
    theta, A, ln, lm = _random_problem(rng, B, N, M)
    W = jnp.asarray(rng.standard_normal((B, N, M)))
    theta, A = jnp.asarray(theta), jnp.asarray(A)
    lnj, lmj = jnp.asarray(ln), jnp.asarray(lm)

    def loss_custom(theta, A):
        E = dp_mod.expected_alignment(theta, A, (lnj, lmj), mode=mode)
        return jnp.sum(jnp.sin(E) * W)

    def loss_ad(theta, A):
        def s(t, a):
            vt, _ = dp_scan.forward_scan(
                skew(t), skew(a), lnj, lmj, mode=mode)
            return vt.sum()
        E = jax.grad(s)(theta, A)
        return jnp.sum(jnp.sin(E) * W)

    np.testing.assert_allclose(loss_custom(theta, A), loss_ad(theta, A),
                               rtol=1e-10)
    g_c = jax.grad(loss_custom, argnums=(0, 1))(theta, A)
    g_ad = jax.grad(loss_ad, argnums=(0, 1))(theta, A)
    np.testing.assert_allclose(g_c[0], g_ad[0], atol=1e-8)
    np.testing.assert_allclose(g_c[1], g_ad[1], atol=1e-8)


def test_traceback_golden():
    """Golden traceback on a deterministic potential (style of
    reference: deepblast/tests/test_nw.py:43-54)."""
    rng = np.random.default_rng(6)
    N, M = 5, 4
    theta = jnp.asarray(rng.standard_normal((1, N, M)) * 2.0)
    A = jnp.full((1, N, M), -1.0)
    E = dp_mod.expected_alignment(theta, A)
    states = dp_mod.traceback(np.asarray(E[0]))
    # path must start at (0,0)-ish after gap padding and end at (N-1, M-1)
    assert states[-1][:2] == (N - 1, M - 1)
    assert states[0][0] == 0 or states[0][1] == 0
    # transitions are valid single steps; a cell's state labels the move
    # out of it (the reference's tape-consumption convention)
    for (i0, j0, s0), (i1, j1, _) in zip(states, states[1:]):
        di, dj = i1 - i0, j1 - j0
        assert (di, dj) in {(1, 0), (0, 1), (1, 1)}
        assert s0 == {(1, 0): 0, (1, 1): 1, (0, 1): 2}[(di, dj)]
    # the label sequence consumes both sequences exactly
    xs = sum(1 for _, _, s in states if s in (0, 1))
    ys = sum(1 for _, _, s in states if s in (1, 2))
    assert xs == N and ys == M


@pytest.mark.parametrize("mode", ["nw", "sw"])
@pytest.mark.parametrize("operator", ["softmax", "sparsemax"])
def test_second_order_finite_difference(mode, operator):
    """Directional finite-difference check of the second-order path, for
    both modes and both smooth operators — the external oracle the
    reference covers with gradgradcheck (reference:
    deepblast/tests/test_nw.py:69-79, deepblast/tests/test_sw.py).  The SW
    adjoint bounds intentionally deviate from the reference
    (self-consistent; see dp_scan.py), so internal double-AD consistency
    alone would not catch a wrong-but-consistent adjoint."""
    rng = np.random.default_rng(7)
    B, N, M = 2, 5, 4
    theta = jnp.asarray(rng.standard_normal((B, N, M)))
    A = jnp.asarray(rng.standard_normal((B, N, M)) - 0.5)
    W = jnp.asarray(rng.standard_normal((B, N, M)))
    dirn_t = jnp.asarray(rng.standard_normal((B, N, M)))
    dirn_a = jnp.asarray(rng.standard_normal((B, N, M)))

    def loss(t, a):
        E = dp_mod.expected_alignment(t, a, mode=mode, operator=operator)
        return jnp.sum(E * W)

    gt, ga = jax.grad(loss, argnums=(0, 1))(theta, A)
    eps = 1e-5
    fd_t = (loss(theta + eps * dirn_t, A)
            - loss(theta - eps * dirn_t, A)) / (2 * eps)
    fd_a = (loss(theta, A + eps * dirn_a)
            - loss(theta, A - eps * dirn_a)) / (2 * eps)
    np.testing.assert_allclose(jnp.vdot(gt, dirn_t), fd_t,
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(jnp.vdot(ga, dirn_a), fd_a,
                               rtol=1e-4, atol=1e-7)
