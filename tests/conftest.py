"""Test configuration.

JAX runs on the CPU with 8 virtual devices, so the multi-device sharding
logic (mesh/shard_map/ppermute) is exercised without GPUs, and the GPU
kernel runs in the Pallas interpreter.  Tests that only a GPU can run carry
the ``gpu`` marker and skip elsewhere; run them on a GPU machine with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU")
