"""Test-session setup.

Tests run on the CPU unless JAX_PLATFORMS names a platform explicitly:
`JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu` runs the tests that
need the card (see README). Multi-device sharding tests use a virtual
8-device CPU mesh.
"""
import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The GPU the test runs on; skips when JAX's default device is not a
    GPU. The test body runs with x64 off, as the program does."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda,cpu on the card")
    with jax.enable_x64(False):
        yield dev
