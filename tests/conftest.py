"""Test configuration.

Tests run on CPU with 8 virtual devices so multi-chip sharding paths are
exercised without a TPU pod (SURVEY.md §4.6).  Must be set before JAX
initializes a backend.
"""

import os
import random
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# jax is pre-imported at interpreter startup in this image, so env vars
# alone are too late for its config: force the platform through the
# config API (valid until the first backend initialization).
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# The 753-bit limb graphs are compile-heavy; persisting compiled
# executables across test runs would help — but WRITING some of the
# suite's largest XLA:CPU executables to JAX's persistent cache
# segfaults inside executable.serialize() (observed round 5:
# rc=139 with the top frame at compilation_cache.put_executable_and_time
# during test_device_msm — this, not slowness, is why no complete
# full-suite run ever finished in rounds 3-4).  Default OFF; opt back in
# with GROTH16_TEST_COMPILE_CACHE=1 for runs that avoid the big modules.
if os.environ.get("GROTH16_TEST_COMPILE_CACHE", "0") != "0":
    os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                          os.path.expanduser("~/.cache/jax_comp_cache"))
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "2")
    os.environ.setdefault(
        "JAX_PERSISTENT_CACHE_ENABLE_XLA_CACHES",
        "xla_gpu_per_fusion_autotune_cache_dir")
else:
    # jax is pre-imported at interpreter startup (and the image hook may
    # have initialized a cache dir), so the env var would be read too
    # late — disable through the config API like the platform pin above.
    jax.config.update("jax_enable_compilation_cache", False)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest


@pytest.fixture
def rng():
    return random.Random(0xC0DA)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-process / long-compile tests")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips without one)")
