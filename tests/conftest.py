"""Test configuration: the suite runs on the CPU with 8 virtual devices so
sharding tests run without multi-card hardware (SURVEY.md §4 implications:
the reference never had distributed tests; we validate meshes on a virtual
8-device CPU topology).

Tests that need the card carry the ``gpu`` marker and the ``gpu`` fixture;
``python -m pytest -m gpu tests/`` runs them on the default JAX platform
(the GPU on a machine with one), and the fixture skips them elsewhere. The
set of collected tests never depends on the hardware.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402  (import after env setup)

jax.config.update("jax_threefry_partitionable", True)
# no persistent compilation cache here: the tests compile many small
# programs once each, and a shared on-disk cache would couple the xdist
# workers


def pytest_configure(config):
    # `-m gpu` selects the on-card tests: leave JAX its default platform so
    # they reach the card; every other selection runs on the CPU mesh
    gpu_run = config.getoption("markexpr", "") == "gpu"
    jax.config.update("jax_platforms", None if gpu_run else "cpu")


@pytest.fixture
def gpu():
    """Skips the test unless JAX's first device is a GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: python -m pytest -m gpu tests/")
