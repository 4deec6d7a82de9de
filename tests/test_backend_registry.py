"""DP backend registry semantics (VERDICT round-1 weak item 7).

``_build`` lru-caches the custom_vjp pair per *resolved* backend name, and
the default is resolved at call time — so registering a new default after
an early cached call must route subsequent default calls to the new
backend, never pin the stale one.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from deepblast_jax.ops import dp as dp_mod


@pytest.fixture
def registry_guard():
    default = dp_mod._DEFAULT_BACKEND[0]
    added = []
    yield added
    for name in added:
        dp_mod._BACKENDS.pop(name, None)
    dp_mod._DEFAULT_BACKEND[0] = default


def _spy_backend(calls, name):
    base = dp_mod._BACKENDS["scan"]

    def forward(*args, **kw):
        calls.append(name)
        return base["forward"](*args, **kw)

    return {**base, "forward": forward}


def test_later_default_registration_is_picked_up(registry_guard):
    rng = np.random.default_rng(0)
    theta = jnp.asarray(rng.standard_normal((1, 4, 4)))
    A = jnp.asarray(rng.standard_normal((1, 4, 4)))

    # early default call populates the lru cache for "scan"
    e0 = dp_mod.expected_alignment(theta, A)

    calls = []
    dp_mod.register_backend("spy", _spy_backend(calls, "spy"),
                            make_default=True)
    registry_guard.append("spy")
    e1 = dp_mod.expected_alignment(theta, A)
    assert calls == ["spy"], "default call did not route to the new default"
    np.testing.assert_allclose(np.asarray(e0), np.asarray(e1), atol=1e-12)

    # explicit name still wins over the default
    calls.clear()
    dp_mod.expected_alignment(theta, A, backend="scan")
    assert calls == []


def test_set_default_backend_rejects_unknown():
    with pytest.raises(ValueError):
        dp_mod.set_default_backend("no-such-backend")
