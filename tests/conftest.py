"""Test configuration: force an 8-device virtual CPU platform.

Multi-device sharding is validated without accelerator hardware via
``--xla_force_host_platform_device_count`` (SURVEY.md section 4d); compute
tests run on CPU for fast compiles and float64 oracle comparisons.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def eight_devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
