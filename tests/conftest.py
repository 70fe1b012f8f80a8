"""Test configuration: JAX on a virtual 8-device CPU mesh, and the `gpu`
marker for the tests that need an NVIDIA GPU.

The suite runs on the CPU: the platform comes from JAX_PLATFORMS and
defaults to "cpu".  Tests marked `gpu` need the card; they skip here
with a reason and run on a GPU host with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu

(chip_smoke.py runs them in its kernel phase).  Whether a GPU is present
is decided in a fixture, never while a module is imported, so every
xdist worker collects the same tests.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if request.node.get_closest_marker("gpu") is None:
        return
    platform = jax.default_backend()
    if platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX runs on {platform}")
