"""The DP under a data-sharded mesh: each device runs the DP of its own
share of the batch (``ops/dp.py::_per_shard``), for either backend.

Runs on the CPU's virtual devices (conftest), where the Triton kernels
run in the interpreter; on cards the same ``shard_map`` holds one
compiled kernel per device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from deepblast_jax.ops import dp as dp_ops
from deepblast_jax.parallel import mesh as mesh_lib

BACKENDS = ["triton", "scan"]


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (virtual) devices")
    return mesh_lib.make_mesh(dp=4, tp=1, devices=jax.devices()[:4])


def _problem(B=8, N=9, M=7, seed=0):
    rng = np.random.default_rng(seed)
    theta = jnp.asarray(rng.standard_normal((B, N, M)), jnp.float32)
    A = jnp.asarray(rng.standard_normal((B, N, M)) - 1.0, jnp.float32)
    ln = jnp.asarray(rng.integers(1, N + 1, B), jnp.int32)
    lm = jnp.asarray(rng.integers(1, M + 1, B), jnp.int32)
    W = jnp.asarray(rng.standard_normal((B, N, M)), jnp.float32)
    return theta, A, ln, lm, W


def _sharded(mesh, *xs):
    sh = NamedSharding(mesh, P("data"))
    return [jax.device_put(x, sh) for x in xs]


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_decode_matches_scan(mesh, backend):
    """jit(expected_alignment) over a data-sharded batch: the output stays
    data-sharded and matches the unsharded scan oracle."""
    theta, A, ln, lm, _ = _problem()
    args = _sharded(mesh, theta, A, ln, lm)
    with mesh_lib.mesh_context(mesh):
        E = jax.jit(lambda t, a, n, m: dp_ops.expected_alignment(
            t, a, (n, m), backend=backend))(*args)
    assert E.sharding.spec == P("data")
    E_ref = dp_ops.expected_alignment(theta, A, (ln, lm), backend="scan")
    np.testing.assert_allclose(np.asarray(E), np.asarray(E_ref), atol=1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_double_grad_matches_scan(mesh, backend):
    """The training path: grad through the decode with the batch sharded;
    gradients match the unsharded scan backend and keep the sharding."""
    theta, A, ln, lm, W = _problem(seed=1)
    args = _sharded(mesh, theta, A)

    def grad(backend):
        return jax.grad(lambda t, a: jnp.sum(W * dp_ops.expected_alignment(
            t, a, (ln, lm), backend=backend)), argnums=(0, 1))

    with mesh_lib.mesh_context(mesh):
        g = jax.jit(grad(backend))(*args)
    g_ref = grad("scan")(theta, A)
    for got, want in zip(g, g_ref):
        assert got.sharding.spec == P("data")
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_score_and_stream(mesh, backend):
    """The search path (score) and the decode stream, sharded: scores on
    the batch axis, the stream on its second (batch) axis."""
    theta, A, ln, lm, _ = _problem(seed=2)
    args = _sharded(mesh, theta, A, ln, lm)
    with mesh_lib.mesh_context(mesh):
        vt = jax.jit(lambda t, a, n, m: dp_ops.alignment_score(
            t, a, (n, m), backend=backend))(*args)
        s = jax.jit(lambda t, a, n, m: dp_ops.expected_alignment_stream(
            t, a, (n, m), backend=backend))(*args)
    assert vt.sharding.spec == P("data")
    assert s.sharding.spec == P(None, "data")
    np.testing.assert_allclose(
        np.asarray(vt),
        np.asarray(dp_ops.alignment_score(theta, A, (ln, lm),
                                          backend="scan")), atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(s),
        np.asarray(dp_ops.expected_alignment_stream(theta, A, (ln, lm),
                                                    backend="scan")),
        atol=1e-6)


@pytest.fixture
def spy_backend():
    seen = []
    base = dp_ops._BACKENDS["triton"]

    def forward(thetad, *args, **kw):
        seen.append(thetad.shape[1])
        return base["forward"](thetad, *args, **kw)

    dp_ops.register_backend("spy", {**base, "forward": forward})
    yield seen
    dp_ops._BACKENDS.pop("spy")
    dp_ops._build.cache_clear()  # its closures hold this fixture's list


@pytest.mark.parametrize("with_mesh", [True, False])
def test_each_device_runs_its_share(mesh, spy_backend, with_mesh):
    """Under the mesh a pass traces for B / 4 pairs (one device's share);
    without it, for the whole batch."""
    theta, A, ln, lm, W = _problem(seed=3)
    args = _sharded(mesh, theta, A)
    loss = jax.grad(lambda t, a: jnp.sum(W * dp_ops.expected_alignment(
        t, a, (ln, lm), backend="spy")))
    with mesh_lib.mesh_context(mesh if with_mesh else None):
        jax.jit(loss).lower(*args)
    assert spy_backend == [2 if with_mesh else 8]


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_training_gradient_moves_no_pairs(mesh, backend):
    """The compiled, sharded DP training gradient gathers nothing: no pair
    leaves the device that holds it."""
    theta, A, ln, lm, W = _problem(seed=4)
    args = _sharded(mesh, theta, A, W)
    grad = jax.jit(jax.grad(lambda t, a, w: jnp.sum(
        w * dp_ops.expected_alignment(t, a, (ln, lm), backend=backend)),
        argnums=(0, 1)))
    with mesh_lib.mesh_context(mesh):
        hlo = grad.lower(*args).compile().as_text()
    for op in ("all-gather", "all-to-all", "collective-permute"):
        assert op + "(" not in hlo, op


def test_no_mesh_context_is_a_no_op():
    with mesh_lib.mesh_context(None):
        assert jax.sharding.get_abstract_mesh().empty


def test_mesh_train_step_on_triton_backend(mesh):
    """A train step on the data mesh with backend='triton': sharded batch,
    heads, skew, the DP kernels and their adjoints, the optimizer."""
    from deepblast_jax.data import ProtT5Tokenizer, TMAlignDataset
    from deepblast_jax.train import DeepBLAST, DeepBLASTConfig
    from tests.test_train import fixture_frame

    cfg = DeepBLASTConfig(embedding_dim=16, hidden_dim=16, layers=2,
                          vocab_size=32, batch_size=4, learning_rate=1e-2,
                          epochs=1, scheduler="none", pad_multiple=8,
                          max_len=32, backend="triton")
    ds = TMAlignDataset(fixture_frame(4, min_len=6, max_len=12),
                        tokenizer=ProtT5Tokenizer())
    model = DeepBLAST(cfg)
    state, history = model.fit(ds, mesh=mesh)
    assert model.mesh is mesh
    assert np.isfinite(history[-1]["train_loss"])
    assert jax.sharding.get_abstract_mesh().empty
    batch = next(iter(model._batches(ds, False, 0)))
    arrays = model._device_batch(batch)
    assert arrays["x"].sharding.spec == P("data")
