"""Test harness configuration.

Multi-"node" testing follows the survey's mapping of the reference strategy
(reference tests use nr_threads=2 with pthreads; we use an 8-device virtual
CPU mesh via --xla_force_host_platform_device_count, SURVEY.md §4).
Double precision is enabled so results are comparable at the reference's
1e-6 tolerance.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

# Tests always run on the virtual 8-device CPU mesh, also on a machine
# with an accelerator.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

from sparsex_jax.config import Config  # noqa: E402


@pytest.fixture(autouse=True)
def fresh_config():
    """Reset the Config singleton around every test."""
    Config.reset()
    yield
    Config.reset()
