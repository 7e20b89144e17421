"""Test configuration: force the CPU backend with 8 virtual devices so
multi-device sharding paths are exercised without a GPU.  jax_platforms
is set through config.update (valid until the first backend
initialization) and XLA_FLAGS before the CPU client is created.

Tests that need the card carry the ``gpu`` marker and skip here (the
check runs inside the ``gpu_device`` fixture, never at import time, so
every xdist worker collects the same tests).  On the card they run
with ``TPUFLUIDS_GPU_TESTS=1 python -m pytest -m gpu tests/``.
"""

import os

# TPUFLUIDS_GPU_TESTS=1 leaves the platform alone, for the ``gpu``
# tests on the card: python -m pytest -m gpu tests/
ON_CARD = os.environ.get("TPUFLUIDS_GPU_TESTS") == "1"

flags = os.environ.get("XLA_FLAGS", "")
if not ON_CARD and "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_prng_impl", "threefry2x32")


def pytest_configure(config):
    if ON_CARD:
        return
    assert jax.devices()[0].platform == "cpu", jax.devices()
    assert len(jax.devices()) == 8, jax.devices()
