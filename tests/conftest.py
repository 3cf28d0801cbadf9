"""Test configuration: run on a virtual 8-device CPU mesh.

Tests exercise numerics and multi-device sharding logic on host-platform
fake devices (the framework's equivalent of the reference's sw_emu tier,
GIN/Makefile:108-111); GPU benchmarking lives in bench.py and
chip_smoke.py. Tests marked ``gpu`` need the card and skip elsewhere; run
them on a GPU machine with ``FLOWGNN_TEST_PLATFORM=cuda python -m pytest
tests/ -m gpu``.

Env vars must be set before jax is imported anywhere.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("FLOWGNN_TEST_PLATFORM", "cpu"))
# Exactness tests compare the f64 JAX path against the f64 NumPy oracles.
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from flowgnn_tpu.core.synthetic import synthetic_molhiv  # noqa: E402
from flowgnn_tpu.models import registry  # noqa: E402

REFERENCE_ROOT = "/root/reference"


@pytest.fixture(scope="session")
def graphs16():
    """16 synthetic molhiv-like graphs with eigenvectors, fixed seed."""
    return synthetic_molhiv(16, seed=7, with_eigen=True)


@pytest.fixture(scope="session")
def reference_root():
    """The reference tree, for the tests that need its own binaries or HLS
    sources (loaders, golden kernels); they skip where it is absent."""
    if not os.path.isdir(REFERENCE_ROOT):
        pytest.skip("reference tree not mounted")
    return REFERENCE_ROOT


@pytest.fixture
def gpu():
    """The first JAX device, for tests that only mean something on a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev


def seeded_params(name: str, seed: int = 0) -> dict:
    """Seeded weights at the model's published widths (params/seeded.py)."""
    return registry.load_params(name, seed)


def assert_allclose(a, b, rtol=2e-5, atol=2e-5, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=msg)
