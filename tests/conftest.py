"""Test harness bootstrap.

Tests run on the local CPU backend with 8 virtual devices (for mesh and
sharding tests, SURVEY.md §4) and x64 (float64 parity with the reference's
gpflow numerics).  No test needs an accelerator.
"""
import os

# Must happen before the first JAX backend initialization.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
