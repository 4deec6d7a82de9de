"""Test configuration.

Tests run on CPU with 8 virtual devices so sharding/multi-device logic is
exercised without cards; the Pallas DP kernels run in the interpreter there.
float64 is enabled for finite-difference oracles.  Tests marked ``gpu`` need
a card (the marker is registered in pyproject.toml): they skip on the CPU
and run on one with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

import pytest

if "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8"
                               ).strip()

import jax  # noqa: E402

from deepblast_jax.utils.cache import enable_compile_cache  # noqa: E402

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
enable_compile_cache()


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (decided at run time)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU")
