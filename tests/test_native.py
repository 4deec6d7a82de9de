"""Native C traceback walker: exact parity with the Python oracle walk.

The C walker (deepblast_jax/native/ctraceback.c) must reproduce
ops.dp._traceback_walk bit-for-bit — same tie order, sentinel handling,
border guards, trailing-gap padding — over both cell layouts (natural
matrix, diagonal E stream).
"""

import numpy as np
import pytest

import deepblast_jax.native as native
from deepblast_jax.ops import dp as dp_mod


def _require_native():
    if native.get_lib() is None:
        pytest.skip("native lib unavailable")


def _oracle_natural(grad):
    g = np.asarray(grad)
    return dp_mod._traceback_walk(lambda i, j: g[i, j], *g.shape)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (9, 1), (24, 17),
                                   (64, 64), (33, 80)])
def test_affine_natural_parity(dtype, shape):
    _require_native()
    rng = np.random.default_rng(hash(shape) % 2**31)
    grad = rng.standard_normal(shape).astype(dtype)
    got = native.traceback_affine(grad, shape[1], 1, *shape)
    assert got == _oracle_natural(grad)


def test_affine_nan_matches_numpy_argmax():
    """np.argmax treats NaN as the maximum (first NaN wins); the C walk
    must follow the same path on matrices containing NaN (e.g. decoded
    from a diverged model) to keep bit-for-bit oracle parity."""
    _require_native()
    g = np.zeros((4, 4), np.float32)
    g[1, 2] = np.nan
    assert native.traceback_affine(g, 4, 1, 4, 4) == _oracle_natural(g)
    g2 = np.zeros((5, 6), np.float32)
    g2[2, 2] = np.nan
    g2[2, 3] = np.nan  # adjacent NaNs: first-NaN-wins order matters
    assert native.traceback_affine(g2, 6, 1, 5, 6) == _oracle_natural(g2)
    g3 = np.full((3, 3), np.nan, np.float32)
    assert native.traceback_affine(g3, 3, 1, 3, 3) == _oracle_natural(g3)


def test_affine_tie_order_and_sentinel():
    """Exact ties must pick left > diag > up (np.argmax first-max);
    cells holding exactly -100000.0 count as the break sentinel."""
    _require_native()
    g = np.zeros((5, 5), np.float32)  # all ties -> always 'left'
    got = native.traceback_affine(g, 5, 1, 5, 5)
    assert got == _oracle_natural(g)
    g2 = np.full((4, 6), -100000.0, np.float32)  # immediate sentinel break
    got2 = native.traceback_affine(g2, 6, 1, 4, 6)
    assert got2 == _oracle_natural(g2)


def test_traceback_entrypoint_uses_native(monkeypatch):
    """dp.traceback routes through the native walk and falls back to
    Python when disabled — identical output both ways."""
    rng = np.random.default_rng(3)
    grad = rng.standard_normal((31, 22)).astype(np.float32)
    fast = dp_mod.traceback(grad)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)
    slow = dp_mod.traceback(grad)
    assert fast == slow


@pytest.mark.parametrize("backend", ["scan", "triton"])
def test_stream_affine_parity(backend):
    """The native affine walk over the diagonal E stream of either
    backend matches the natural-layout walk."""
    _require_native()
    rng = np.random.default_rng(11)
    B, N, M = 3, 24, 17
    theta = np.asarray(rng.standard_normal((B, N, M)), np.float32)
    A = np.asarray(rng.standard_normal((B, N, M)) - 1.0, np.float32)
    ln = np.asarray([N, N - 3, N - 7], np.int32)
    lm = np.asarray([M, M - 1, M - 6], np.int32)
    E = dp_mod.expected_alignment(theta, A, (ln, lm), backend=backend)
    s = np.asarray(dp_mod.expected_alignment_stream(
        theta, A, (ln, lm), backend=backend))
    for b in range(B):
        n, m = int(ln[b]), int(lm[b])
        want = dp_mod.traceback(np.asarray(E[b, :n, :m]))
        flat, si, sj = dp_mod.stream_affine(s, b)
        assert native.traceback_affine(flat, si, sj, n, m) == want
        assert dp_mod.traceback_stream(s, n, m, b) == want
