"""Test configuration.

The suite runs on the CPU: ``JAX_PLATFORMS=cpu python -m pytest tests/``.
The CPU backend gets 8 virtual devices for the mesh tests, which pass CPU
devices to make_mesh explicitly. Tests marked ``gpu`` need an NVIDIA GPU;
the ``gpu_device`` fixture decides at run time whether there is one and
skips the test otherwise.
"""

import os
import sys

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: tests that need an NVIDIA GPU (skip without one)")


@pytest.fixture
def gpu_device():
    import jax
    try:
        return jax.devices("gpu")[0]
    except RuntimeError as e:
        pytest.skip("no GPU backend: %s" % e)
