"""Test harness configuration.

Runs everything on CPU with 8 virtual devices so the sharded paths run
without a multi-GPU host (SURVEY §4: the analog of the reference's
fake-backend precedents), and enables x64 so oracles can be computed in
double precision.
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from bachelors_tpu.app.driver import _default_compile_cache  # noqa: E402

# persistent compile cache: JAX_COMPILATION_CACHE_DIR when set, else the
# fixed path inside the checkout -- the same rule as the driver
_default_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0x5EED)
