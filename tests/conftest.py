"""
Test configuration: run everything on a virtual 8-device CPU mesh so
multi-device sharding logic is exercised without accelerator hardware.
The tests marked ``gpu`` run on a card with ``JAX_PLATFORMS=cuda``
(tests/test_gpu.py says how).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# the CPU suite, child processes included, writes no executables into the
# checkout's compile cache
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if os.environ["JAX_PLATFORMS"] == "cpu":
    jax.config.update("jax_default_device", "cpu")
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)
