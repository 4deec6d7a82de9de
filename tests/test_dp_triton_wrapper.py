"""What surrounds the Triton DP kernels: the gradient rules through
``ops/dp.py``, the choice of backend and of interpret mode, the lane
padding, and lowering for a GPU (checked here without one)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import export

from deepblast_jax.ops import dp as dp_ops
from deepblast_jax.ops import dp_triton


def _pair_batch(seed=0, B=3, N=7, M=6):
    rng = np.random.default_rng(seed)
    theta = jnp.asarray(rng.standard_normal((B, N, M)))
    A = jnp.asarray(rng.standard_normal((B, N, M)) - 1.0)
    lengths = (jnp.asarray([N, 4, 2]), jnp.asarray([M, 6, 3]))
    return theta, A, lengths


# -- gradient rules -----------------------------------------------------------

@pytest.mark.parametrize("mode", ["nw", "sw"])
def test_score_grad_matches_scan(mode):
    theta, A, lengths = _pair_batch(1)

    def grad(backend):
        return jax.grad(lambda t, a: jnp.sum(dp_ops.alignment_score(
            t, a, lengths, mode=mode, backend=backend)), argnums=(0, 1))(
                theta, A)

    for g, w in zip(grad("triton"), grad("scan")):
        np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("mode", ["nw", "sw"])
def test_double_grad_matches_scan(mode):
    theta, A, lengths = _pair_batch(2)
    W = jnp.asarray(np.random.default_rng(5).standard_normal(theta.shape))

    def grad(backend):
        return jax.grad(lambda t, a: jnp.sum(W * dp_ops.expected_alignment(
            t, a, lengths, mode=mode, backend=backend)), argnums=(0, 1))(
                theta, A)

    for g, w in zip(grad("triton"), grad("scan")):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("mode", ["nw", "sw"])
def test_score_grad_is_expected_alignment(mode):
    """d Vt / d theta is the expected alignment E, and d Vt / d A its gap
    usage E_A (the first-level custom_vjp)."""
    theta, A, lengths = _pair_batch(3)
    g_theta, g_A = jax.grad(lambda t, a: jnp.sum(dp_ops.alignment_score(
        t, a, lengths, mode=mode, backend="triton")), argnums=(0, 1))(
            theta, A)
    E, EA = dp_ops.expected_alignment(theta, A, lengths, mode=mode,
                                      backend="triton", return_gap=True)
    np.testing.assert_allclose(g_theta, E, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(g_A, EA, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("mode", ["nw", "sw"])
def test_gap_double_grad_matches_scan(mode):
    """The second-order rule with a gap cotangent (``return_gap=True``)."""
    theta, A, lengths = _pair_batch(4)
    W = jnp.asarray(np.random.default_rng(6).standard_normal(theta.shape))

    def grad(backend):
        def f(t, a):
            E, EA = dp_ops.expected_alignment(t, a, lengths, mode=mode,
                                              backend=backend,
                                              return_gap=True)
            return jnp.sum(W * E) + jnp.sum(W[::-1] * EA)
        return jax.grad(f, argnums=(0, 1))(theta, A)

    for g, w in zip(grad("triton"), grad("scan")):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("mode", ["nw", "sw"])
def test_score_grad_finite_differences(mode):
    theta, A, lengths = _pair_batch(5, B=1, N=4, M=3)
    lengths = (jnp.asarray([4]), jnp.asarray([3]))

    def f(t):
        return jnp.sum(dp_ops.alignment_score(t, A, lengths, mode=mode,
                                              backend="triton"))

    g = np.asarray(jax.grad(f)(theta))
    eps = 1e-6
    for idx in [(0, 0, 0), (0, 2, 1), (0, 3, 2)]:
        d = np.zeros(theta.shape)
        d[idx] = eps
        fd = (float(f(theta + d)) - float(f(theta - d))) / (2 * eps)
        np.testing.assert_allclose(g[idx], fd, rtol=1e-6, atol=1e-9)


# -- choice of backend and of interpret mode ---------------------------------

@pytest.mark.parametrize("platform,want", [("gpu", "triton"), ("cpu", "scan"),
                                           ("metal", "scan")])
def test_platform_default_backend(platform, want):
    assert dp_ops.platform_default_backend(platform) == want


def test_default_backend_on_cpu_is_scan_and_resets():
    assert dp_ops.get_backend(None)[0] == "scan"
    dp_ops.set_default_backend("triton")
    try:
        assert dp_ops.get_backend(None)[0] == "triton"
    finally:
        dp_ops.set_default_backend(None)
    assert dp_ops.get_backend(None)[0] == "scan"
    with pytest.raises(ValueError):
        dp_ops.get_backend("no-such-backend")


@pytest.mark.parametrize("platform,want", [("cpu", True), ("gpu", False)])
def test_interpret_mode(platform, want):
    assert dp_triton.interpret_mode(platform) is want


def test_triton_backend_refuses_other_platforms(monkeypatch):
    """On a platform that is neither cpu nor gpu the kernels raise rather
    than running in the interpreter."""
    with pytest.raises(NotImplementedError):
        dp_triton.interpret_mode("metal")
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    theta, A, lengths = _pair_batch(0)
    with pytest.raises(NotImplementedError):
        dp_ops.alignment_score(theta, A, lengths, backend="triton")


@pytest.mark.parametrize("N,P", [(1, 16), (16, 16), (17, 32), (512, 512),
                                 (513, 1024)])
def test_lanes_cover_slots_in_a_power_of_two(N, P):
    assert dp_triton.lanes(N) == P


def test_stream_too_large_for_int32_offsets():
    with pytest.raises(ValueError):
        dp_triton._check_size(2 ** 12, 2 ** 10, 2 ** 9)


@pytest.mark.parametrize("name", ["forward", "forward_score", "backward",
                                  "adjoint_forward", "adjoint_backward"])
def test_passes_refuse_streams_beyond_int32_offsets(name):
    """Every pass refuses, while tracing, a batch whose stream offsets
    would wrap in int32 (B=1024 at 1024 x 1024 fits on a card)."""
    B, N = 1024, 1024
    K = 2 * N - 1
    f32 = jnp.float32
    sd = jax.ShapeDtypeStruct
    pot, res = sd((K, B, N), f32), sd((K, B, N + 1), f32)
    lens, vec = sd((B,), jnp.int32), sd((B,), f32)
    calls = {
        "forward": (dp_triton.forward, (pot, pot, lens, lens)),
        "forward_score": (dp_triton.forward_score, (pot, pot, lens, lens)),
        "backward": (lambda e, x, m, y, l1, l2: dp_triton.backward(
            e, (x, m, y), l1, l2), (vec, res, res, res, lens, lens)),
        "adjoint_forward": (lambda x, m, y, z, l1, l2:
                            dp_triton.adjoint_forward((x, m, y), z, None, l1,
                                                      l2),
                            (res, res, res, pot, lens, lens)),
        "adjoint_backward": (lambda e, x, m, y, dx, dm, dy, l1, l2:
                             dp_triton.adjoint_backward(
                                 e, (x, m, y), (dx, dm, dy), l1, l2),
                             (res,) * 7 + (lens, lens)),
    }
    fn, args = calls[name]
    with pytest.raises(ValueError, match="int32"):
        jax.eval_shape(fn, *args)


def test_padded_batch_matches_unpadded():
    """Padding a pair to a wider buffer changes nothing inside its true
    lengths (the kernels mask cells and bound loops by length)."""
    theta, A, _ = _pair_batch(7, B=1, N=5, M=4)
    lengths = (jnp.asarray([5]), jnp.asarray([4]))
    E = dp_ops.expected_alignment(theta, A, lengths, backend="triton")
    pad = ((0, 0), (0, 6), (0, 9))
    Ep = dp_ops.expected_alignment(jnp.pad(theta, pad), jnp.pad(A, pad),
                                   lengths, backend="triton")
    np.testing.assert_allclose(Ep[:, :5, :4], E, rtol=1e-12, atol=1e-14)
    assert np.all(np.asarray(Ep[:, 5:]) == 0)
    assert np.all(np.asarray(Ep[:, :, 4:]) == 0)


# -- lowering for a GPU, without one -------------------------------------------

def _lower_for_cuda(fn, *args):
    exp = export.export(
        jax.jit(fn), platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(*args)
    return exp.mlir_module()


# the operator only enters the two forward recursions
_LOWERINGS = ([(n, "softmax") for n in (
    "forward", "forward_score", "backward", "adjoint_forward",
    "adjoint_forward_no_gap", "adjoint_backward")]
    + [(n, op) for n in ("forward", "adjoint_forward")
       for op in ("sparsemax", "hardmax")])


@pytest.mark.parametrize("name,operator", _LOWERINGS)
def test_kernels_lower_to_triton_for_cuda(monkeypatch, name, operator):
    """The Pallas-to-Triton lowering accepts every kernel: the module holds
    one Triton call per pass (the GPU's own compiler runs only on a card)."""
    monkeypatch.setattr(dp_triton, "interpret_mode", lambda p=None: False)
    B, N, M = 2, 9, 7
    K = N + M - 1
    f32 = jnp.float32
    sd = jax.ShapeDtypeStruct
    pot, res = sd((K, B, N), f32), sd((K, B, N + 1), f32)
    lens, vec = sd((B,), jnp.int32), sd((B,), f32)
    kw = dict(operator=operator)
    fns = {
        "forward": (lambda t, a, l1, l2: dp_triton.forward(t, a, l1, l2,
                                                           **kw),
                    (pot, pot, lens, lens)),
        "forward_score": (lambda t, a, l1, l2: dp_triton.forward_score(
            t, a, l1, l2, **kw), (pot, pot, lens, lens)),
        "backward": (lambda e, x, m, y, l1, l2: dp_triton.backward(
            e, (x, m, y), l1, l2), (vec, res, res, res, lens, lens)),
        "adjoint_forward": (lambda x, m, y, z, za, l1, l2:
                            dp_triton.adjoint_forward((x, m, y), z, za, l1,
                                                      l2, **kw),
                            (res, res, res, pot, pot, lens, lens)),
        "adjoint_forward_no_gap": (lambda x, m, y, z, l1, l2:
                                   dp_triton.adjoint_forward(
                                       (x, m, y), z, None, l1, l2, **kw),
                                   (res, res, res, pot, lens, lens)),
        "adjoint_backward": (lambda e, x, m, y, dx, dm, dy, l1, l2:
                             dp_triton.adjoint_backward(
                                 e, (x, m, y), (dx, dm, dy), l1, l2),
                             (res,) * 7 + (lens, lens)),
    }
    fn, args = fns[name]
    text = _lower_for_cuda(fn, *args)
    assert text.count("__gpu$xla.gpu.triton") == 1


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["nw", "sw"])
def test_compiled_kernels_match_scan_on_gpu(gpu, mode):
    """The kernels as Triton compiles them for the card (no interpreter)
    against the scan oracle, through the double grad."""
    rng = np.random.default_rng(11)
    B, N, M = 8, 100, 77
    theta = jnp.asarray(rng.standard_normal((B, N, M)), jnp.float32)
    A = jnp.asarray(rng.standard_normal((B, N, M)) - 1.0, jnp.float32)
    lengths = (jnp.asarray(rng.integers(1, N + 1, B)),
               jnp.asarray(rng.integers(1, M + 1, B)))
    W = jnp.asarray(rng.standard_normal((B, N, M)), jnp.float32)

    def grad(backend):
        return jax.jit(jax.grad(lambda t, a: jnp.sum(
            W * dp_ops.expected_alignment(t, a, lengths, mode=mode,
                                          backend=backend)),
            argnums=(0, 1)))(theta, A)

    for g, w in zip(grad("triton"), grad("scan")):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
