"""The Triton DP kernels (Pallas interpreter on the CPU) against the scan
oracle, pass by pass.

Each pass of :mod:`deepblast_jax.ops.dp_triton` reads and writes the same
stream layout as its :mod:`deepblast_jax.ops.dp_scan` counterpart, so every
kernel is fed the oracle's own inputs and residuals and compared on its own.
The shapes cover ragged lengths, N != M, length-1 sequences, a slot count
that is not a power of two, and pairs shorter than their buffer.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from deepblast_jax.ops import dp_scan, dp_triton
from deepblast_jax.ops.skew import skew

# (B, N, M, ln, lm): lengths None means the full buffer
SHAPES = {
    "full_square": (2, 8, 8, None, None),
    "ragged_n_ne_m": (3, 9, 6, [9, 4, 7], [6, 6, 2]),
    "length_one": (3, 5, 4, [1, 5, 1], [4, 1, 1]),
    "slots_not_pow2": (2, 17, 11, [17, 12], [11, 9]),
}
PASSES = ["forward", "forward_score", "backward", "adjoint_forward",
          "adjoint_forward_no_gap", "adjoint_backward"]


@functools.lru_cache(maxsize=None)
def _case(shape, mode, operator="softmax"):
    """Inputs and every scan pass's outputs for one shape."""
    B, N, M, ln, lm = SHAPES[shape]
    rng = np.random.default_rng(2 * sorted(SHAPES).index(shape)
                                + (mode == "sw"))
    theta = jnp.asarray(rng.standard_normal((B, N, M)))
    A = jnp.asarray(rng.standard_normal((B, N, M)) - 1.0)
    ln = jnp.asarray(ln if ln is not None else [N] * B, jnp.int32)
    lm = jnp.asarray(lm if lm is not None else [M] * B, jnp.int32)
    td, ad = skew(theta), skew(A)
    zt = skew(jnp.asarray(rng.standard_normal((B, N, M))))
    za = skew(jnp.asarray(rng.standard_normal((B, N, M))))
    Et = jnp.asarray(rng.uniform(0.5, 2.0, B))
    kw = dict(mode=mode, operator=operator)
    vt, qs = dp_scan.forward_scan(td, ad, ln, lm, **kw)
    E = dp_scan.backward_scan(Et, qs, ln, lm, mode=mode)
    vtd, qds = dp_scan.adjoint_forward_scan(qs, zt, za, ln, lm, **kw)
    vtd0, qds0 = dp_scan.adjoint_forward_scan(qs, zt, jnp.zeros_like(za),
                                              ln, lm, **kw)
    Ed = dp_scan.adjoint_backward_scan(E, qs, qds, ln, lm, mode=mode)
    return dict(td=td, ad=ad, zt=zt, za=za, Et=Et, ln=ln, lm=lm, vt=vt,
                qs=qs, E=E, vtd=vtd, qds=qds, vtd0=vtd0, qds0=qds0, Ed=Ed)


def _run(name, c, mode, operator="softmax"):
    """(kernel outputs, oracle outputs) of one pass."""
    kw = dict(mode=mode, operator=operator)
    ln, lm = c["ln"], c["lm"]
    if name == "forward":
        return (dp_triton.forward(c["td"], c["ad"], ln, lm, **kw),
                (c["vt"], c["qs"]))
    if name == "forward_score":
        return dp_triton.forward_score(c["td"], c["ad"], ln, lm, **kw), c["vt"]
    if name == "backward":
        return (dp_triton.backward(c["Et"], c["qs"], ln, lm, mode=mode),
                c["E"])
    if name == "adjoint_forward":
        return (dp_triton.adjoint_forward(c["qs"], c["zt"], c["za"], ln, lm,
                                          **kw), (c["vtd"], c["qds"]))
    if name == "adjoint_forward_no_gap":
        return (dp_triton.adjoint_forward(c["qs"], c["zt"], None, ln, lm,
                                          **kw), (c["vtd0"], c["qds0"]))
    assert name == "adjoint_backward"
    return (dp_triton.adjoint_backward(c["E"], c["qs"], c["qds"], ln, lm,
                                       mode=mode), c["Ed"])


def _close(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("mode", ["nw", "sw"])
@pytest.mark.parametrize("name", PASSES)
def test_pass_matches_scan(name, mode, shape):
    got, want = _run(name, _case(shape, mode), mode)
    _close(got, want)


@pytest.mark.parametrize("operator", ["softmax", "sparsemax", "hardmax"])
@pytest.mark.parametrize("mode", ["nw", "sw"])
@pytest.mark.parametrize("name", ["forward", "adjoint_forward"])
def test_operator_matches_scan(name, mode, operator):
    got, want = _run(name, _case("ragged_n_ne_m", mode, operator), mode,
                     operator)
    _close(got, want)
