"""Test configuration: an 8-virtual-device CPU platform by default.

The CPU is forced with jax.config.update (which takes effect any time before
the first backend initialization) unless JAX_PLATFORMS names another
platform — ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` runs the
GPU-marked tests on a card.  Sharding tests use the 8 virtual CPU devices
as a stand-in for a multi-GPU host.
"""

import os

import jax
import pytest

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU (decided when
    the test runs, never at import or collection)."""
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU (default backend: {jax.default_backend()})")
