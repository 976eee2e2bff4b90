"""Test configuration.

By default the tests run on the CPU with an 8-device virtual mesh, so
the multi-device sharding tests run on one host and Pallas kernels run
in interpret mode.  With ``TCFORGE_TEST_GPU=1`` JAX keeps its default
platform, and the tests marked ``gpu`` run on the card:

    TCFORGE_TEST_GPU=1 python -m pytest tests -m gpu

Whether a card is present is decided inside the ``gpu_device`` fixture,
never while modules are imported, so every worker collects the same
tests.
"""

import os

import pytest

if not os.environ.get("TCFORGE_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not os.environ.get("TCFORGE_TEST_GPU"):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (TCFORGE_TEST_GPU=1); "
        "skips elsewhere")


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip where JAX has none."""
    d = jax.devices()[0]
    if d.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {d.platform}")
    return d
